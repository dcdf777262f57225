"""The plain model of topk2_fields' pruning (ops/topk.py
topk2_survivors_plain) never drops a centre that the plain top-2 of a
point in its box keeps: a property test over drawn point clusters, with
duplicate, equidistant and invalid centres and N in {1, 2, 3, 64}. The
kernel's own per-box counts are held against this model on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from neural_graph_mapping_tpu_torch.ops import topk  # noqa: E402


@st.composite
def _pruning_case(draw):
    """Points in a few tight clusters (one a box, so a box is small against
    the centres' spread), centres around them with duplicate
    centres, pairs equidistant from a cluster's middle (a point sits exactly
    there) and invalid centres; N in {1, 2, 3, 64}."""
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    n = draw(st.sampled_from([1, 2, 3, 64]))
    box = draw(st.sampled_from([8, 32]))
    boxes = draw(st.integers(1, 4))
    p = boxes * box - draw(st.integers(0, box - 1))
    spread = draw(st.sampled_from([0.01, 0.3, 3.0]))
    mids = rng.normal(size=(boxes, 3)) * 2
    pts = np.repeat(mids, box, axis=0)[:p] + rng.normal(size=(p, 3)) * spread
    pts[::box] = mids[: len(pts[::box])]  # a point exactly at each middle
    cen = rng.normal(size=(n, 3)) * 2
    if n >= 3:
        b = rng.integers(boxes)
        v = rng.normal(size=3)
        cen[0], cen[1] = mids[b] + v, mids[b] - v  # equidistant from the middle point
        cen[2] = cen[rng.integers(2)]  # a duplicate
    if n == 64:
        cen[40:] = np.repeat(mids, 24, axis=0)[:24] + rng.normal(size=(24, 3)) * spread * 2
        cen[50] = cen[45]
    valid = rng.random(n) < draw(st.sampled_from([0.0, 0.5, 1.0]))
    if draw(st.booleans()) and n > 1:
        valid[rng.integers(n)] = True
    return (pts.T.astype(np.float32).copy(), cen.astype(np.float32), valid, box)


@settings(max_examples=150, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(_pruning_case())
def test_pruning_model_never_drops_a_top2_centre(case):
    """topk2_survivors_plain, the plain model of the kernel's pruning by
    box: no centre that the plain top-2 of a point of the box picks is
    dropped, and the plain top-2 over each box's surviving centres is the
    plain top-2 over all of them, bit for bit."""
    pts, cen, valid, box = (torch.from_numpy(np.asarray(x)) if not isinstance(x, int) else x for x in case)
    keep = topk.topk2_survivors_plain(pts, cen, valid, box)
    assert keep.shape == (-(-pts.shape[1] // box), cen.shape[0]) and keep.dtype == torch.bool
    d, i = topk.topk2_fields_plain(pts, cen, valid)
    for b in range(keep.shape[0]):
        sl = slice(b * box, (b + 1) * box)
        assert bool(keep[b][i[:, sl].long()].all())
        bd, bi = topk.topk2_fields_plain(pts[:, sl], cen, valid & keep[b])
        assert torch.equal(bd, d[:, sl]) and torch.equal(bi, i[:, sl])
    if int(valid.sum()) < 2:  # U is +inf: nothing is dropped
        assert bool(keep.all())
