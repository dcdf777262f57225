"""The port's top-2 nearest-field search (ops/topk.py, the plain version a
CPU tensor takes) against the JAX package's Pallas kernel in interpret mode
and its brute-force ``dispatch.topk_fields(k=2)``.

The port computes (p - c)^2 directly, JAX |c|^2 - 2 c.p + |p|^2: distances
agree within 1e-4 m, and an index may differ only where the two nearest
distances are within 1e-4 of each other (the tolerance the JAX package's
tests/test_dispatch_tiled.py allows between its own two versions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np

from neural_graph_mapping_tpu.ops import dispatch as jdispatch
from neural_graph_mapping_tpu.ops import topk_pallas
from neural_graph_mapping_tpu_torch.ops import topk


def _check(want_d, want_i, got_d, got_i):
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    got_d, got_i = to_np(got_d), to_np(got_i)
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(want_d))
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], atol=1e-4)
    mismatch = (got_i != want_i) & fin
    near_tie = np.abs(want_d[0] - want_d[1]) < 1e-4
    assert near_tie[mismatch.any(axis=0)].all()


@pytest.mark.parametrize("n", [5, 128, 300])
def test_topk2_plain_matches_jax(n):
    rng = np.random.default_rng(n)
    pts = (rng.normal(size=(3, 3000)) * 2).astype(np.float32)
    cen = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    valid = rng.random(n) > 0.25
    if n > 10:  # duplicate centres: the lower index wins the tie
        cen[7] = cen[3]
        valid[3] = valid[7] = True
    got_d, got_i = topk.topk2_fields(torch.from_numpy(pts), torch.from_numpy(cen), torch.from_numpy(valid))
    assert got_d.shape == (2, 3000) and got_i.dtype == torch.int32
    want_d, want_i = topk_pallas.topk2_fields(
        jnp.asarray(pts), jnp.asarray(cen), jnp.asarray(valid), interpret=True
    )
    _check(want_d, want_i, got_d, got_i)
    ref_d, ref_i = jdispatch.topk_fields(jnp.asarray(pts.T), jnp.asarray(cen), jnp.asarray(valid), 2)
    _check(np.asarray(ref_d).T, np.asarray(ref_i).T, got_d, got_i)
    if n > 10:  # a point on the duplicated centre: both at distance 0, 3 first
        d, i = topk.topk2_fields(torch.from_numpy(cen[3][:, None].copy()), torch.from_numpy(cen),
                                 torch.from_numpy(valid))
        assert to_np(i)[:, 0].tolist() == [3, 7] and float(d.max()) == 0.0


def test_topk2_all_invalid():
    d, i = topk.topk2_fields(torch.zeros((3, 10)), torch.ones((4, 3)), torch.zeros(4, dtype=torch.bool))
    assert torch.isinf(d).all()
    assert ((i >= 0) & (i < 4)).all()
    # the index of an inf neighbour is any in-range one (JAX's kernel
    # repeats index 0 here; the pair is invalid either way)
    want_d, _ = topk_pallas.topk2_fields(jnp.zeros((3, 10)), jnp.ones((4, 3)), jnp.zeros(4, bool), interpret=True)
    assert np.isinf(np.asarray(want_d)).all()


def test_topk2_single_centre_and_ties():
    """One centre: the second neighbour is inf with the clamped index 0.
    An invalid winner is never ranked before a valid one."""
    pts = torch.tensor([[0.0, 1.0], [0.0, 0.0], [0.0, 0.0]])
    d, i = topk.topk2_fields(pts, torch.zeros((1, 3)), torch.ones(1, dtype=torch.bool))
    assert to_np(i).tolist() == [[0, 0], [0, 0]]
    assert to_np(d)[0].tolist() == [0.0, 1.0] and torch.isinf(d[1]).all()
    cen = torch.tensor([[0.0, 0, 0], [0.1, 0, 0], [5.0, 0, 0]])
    d, i = topk.topk2_fields(pts, cen, torch.tensor([False, True, True]))
    assert to_np(i)[:, 0].tolist() == [1, 2]


def test_topk2_rejects_bad_inputs():
    with pytest.raises(ValueError):
        topk.topk2_fields(torch.zeros((4, 3)), torch.zeros((2, 3)), torch.ones(2, dtype=torch.bool))
    with pytest.raises(TypeError):
        topk.topk2_fields(torch.zeros((3, 4)), torch.zeros((2, 3)), torch.ones(2))
    with pytest.raises(ValueError):
        topk.topk2_fields(torch.zeros((3, 4)), torch.zeros((0, 3)), torch.ones(0, dtype=torch.bool))
    before = dict(topk.LAUNCHES)
    topk.topk2_fields(torch.zeros((3, 4)), torch.zeros((2, 3)), torch.ones(2, dtype=torch.bool))
    assert topk.LAUNCHES == before  # the plain version is no launch


def test_fold_validity_gives_the_plain_top2():
    """The kernel's centres, validity folded in (an invalid centre's x is
    +inf), give the plain top-2 bit for bit with every centre taken as
    valid: the same distances (+inf for an invalid winner) and indices
    (ties to the lower index, clamped to N - 1), also for N = 1 and with
    fewer than two valid centres."""
    rng = np.random.default_rng(8)
    pts = torch.from_numpy((rng.normal(size=(3, 500)) * 2).astype(np.float32))
    for n, valid in ((1, [True]), (1, [False]), (4, [False] * 4), (4, [False, True, False, False]),
                     (64, list(rng.random(64) > 0.3))):
        cen = torch.from_numpy((rng.normal(size=(n, 3)) * 2).astype(np.float32))
        if n > 8:
            cen[7] = cen[3]
        valid = torch.tensor(valid)
        folded = topk.fold_validity(cen, valid)
        assert folded.shape == (n, 4) and folded.dtype == torch.float32
        assert torch.isinf(folded[:, 0]).tolist() == (~valid).tolist()
        got = topk.topk2_fields_plain(pts, folded[:, :3], torch.ones(n, dtype=torch.bool))
        want = topk.topk2_fields_plain(pts, cen, valid)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pruning_model_drops_far_centres():
    """Four points in a small box and centres around it: the far one is
    dropped, the two near ones and the duplicate of one of them survive,
    and the invalid one goes with the far one."""
    pts = torch.tensor([[0.0, 0.1, 0.2, 0.1], [0.0, 0.0, 0.1, 0.1], [0.0, 0.0, 0.0, 0.1]])
    cen = torch.tensor([[0.0, 0.0, 0.5], [10.0, 0, 0], [0.1, 0.1, -0.4], [0.0, 0.0, 0.5], [0.0, 0, 0]])
    valid = torch.tensor([True, True, True, True, False])
    keep = topk.topk2_survivors_plain(pts, cen, valid, 4)
    assert keep.tolist() == [[True, False, True, True, False]]


def test_box_survivors_on_cpu_take_the_plain_model():
    """topk2_box_survivors on CPU tensors: each box's surviving centres as
    the plain model counts them, one count a box of BOX_POINTS points (the
    last box short), no launch."""
    rng = np.random.default_rng(12)
    p = 3 * topk.BOX_POINTS + 5
    pts = torch.from_numpy((rng.normal(size=(3, p)) * 0.05 + np.repeat(rng.normal(size=(3, 4)), 64, 1)[:, :p])
                           .astype(np.float32))
    cen = torch.from_numpy((rng.normal(size=(40, 3)) * 2).astype(np.float32))
    valid = torch.from_numpy(rng.random(40) > 0.2)
    before = dict(topk.LAUNCHES)
    counts = topk.topk2_box_survivors(pts, cen, valid)
    assert topk.LAUNCHES == before
    assert counts.shape == (4,) and counts.dtype == torch.int32
    keep = topk.topk2_survivors_plain(pts, cen, valid)
    assert counts.tolist() == keep.sum(1).tolist()
    assert 0 < int(counts.min()) and int(counts.max()) < 40  # the far centres are dropped
