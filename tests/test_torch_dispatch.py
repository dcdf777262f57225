"""Parity of the port's render dispatch (ops/dispatch.py) with the JAX
package: ``topk_fields`` for k = 1, 2, 3 and ``tiled_dispatch_sorted``,
whose integer outputs must agree one for one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np

from neural_graph_mapping_tpu.ops import dispatch as jdispatch
from neural_graph_mapping_tpu_torch.ops import dispatch


def _topk_inputs(n, seed, dup=True):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(2000, 3)) * 2).astype(np.float32)
    cen = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    valid = rng.random(n) > 0.25
    if dup and n > 8:  # duplicate centres: ties go to the lower index
        cen[7] = cen[3]
        valid[3] = valid[7] = True
    return pts, cen, valid


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n", [2, 40, 130])
def test_topk_fields_matches_jax(k, n):
    """Same expanded-form arithmetic as JAX: distances within 1e-5 m,
    indices equal wherever the distance is finite."""
    pts, cen, valid = _topk_inputs(n, 10 * k + n)
    want_d, want_i = jdispatch.topk_fields(jnp.asarray(pts), jnp.asarray(cen), jnp.asarray(valid), k)
    got_d, got_i = dispatch.topk_fields(torch.from_numpy(pts), torch.from_numpy(cen), torch.from_numpy(valid), k)
    assert got_d.shape == (2000, k) and got_i.dtype == torch.int32
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    np.testing.assert_array_equal(np.isinf(to_np(got_d)), np.isinf(want_d))
    fin = np.isfinite(want_d)
    assert_close(want_d[fin], to_np(got_d)[fin], atol=1e-5)
    np.testing.assert_array_equal(to_np(got_i)[fin], want_i[fin])
    assert (to_np(got_i) >= 0).all() and (to_np(got_i) < n).all()


def test_topk_fields_fewer_centres_than_k():
    pts, cen, valid = _topk_inputs(2, 3, dup=False)
    valid[:] = True
    want_d, want_i = jdispatch.topk_fields(jnp.asarray(pts), jnp.asarray(cen), jnp.asarray(valid), 3)
    got_d, got_i = dispatch.topk_fields(torch.from_numpy(pts), torch.from_numpy(cen), torch.from_numpy(valid), 3)
    assert np.isinf(to_np(got_d)[:, 2]).all()
    np.testing.assert_array_equal(to_np(got_i), np.asarray(want_i))
    assert_close(np.asarray(want_d)[:, :2], to_np(got_d)[:, :2], atol=1e-5)


def _dispatch_both(ids, valid, payload, e, tile):
    want = jdispatch.tiled_dispatch_sorted(
        jnp.asarray(ids, jnp.int32), jnp.asarray(valid), (jnp.asarray(payload),), e, tile
    )
    got = dispatch.tiled_dispatch_sorted(
        torch.from_numpy(np.array(ids, np.int64)), torch.from_numpy(np.array(valid)),
        (torch.from_numpy(payload),), e, tile,
    )
    return want, got


def _assert_dispatch_equal(want, got):
    (wp,), w_orig, w_src, w_exp, w_cnt, w_live, w_tiles = want
    (gp,), g_orig, g_src, g_exp, g_cnt, g_live, g_tiles = got
    assert g_tiles == w_tiles
    np.testing.assert_array_equal(to_np(gp), np.asarray(wp))
    for w, g in ((w_orig, g_orig), (w_src, g_src), (w_exp, g_exp), (w_cnt, g_cnt)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    assert g_live.shape == () and int(g_live) == int(w_live)


@pytest.mark.parametrize("seed,m,e,tile", [(0, 700, 5, 128), (1, 513, 3, 64), (2, 64, 9, 32)])
def test_tiled_dispatch_sorted_random_ids(seed, m, e, tile):
    key = jax.random.PRNGKey(seed)
    ids = np.asarray(jax.random.randint(key, (m,), 0, e))
    valid = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 1), 0.8, (m,)))
    payload = np.arange(m, dtype=np.float32) * 2.0
    _assert_dispatch_equal(*_dispatch_both(ids, valid, payload, e, tile))


def test_tiled_dispatch_sorted_empty_experts():
    ids = np.asarray([1, 1, 2, 2, 2, 4])  # experts 0 and 3 get nothing
    want, got = _dispatch_both(ids, np.ones(6, bool), np.arange(6, dtype=np.float32), 5, 4)
    _assert_dispatch_equal(want, got)
    assert int(got[5]) == 3  # one tile each for experts 1, 2, 4


def test_tiled_dispatch_sorted_all_invalid():
    want, got = _dispatch_both(np.zeros(10), np.zeros(10, bool), np.arange(10, dtype=np.float32), 3, 4)
    _assert_dispatch_equal(want, got)
    assert int(got[5]) == 0 and int(got[4].sum()) == 10


def test_tiled_dispatch_sorted_skewed_demand():
    """One dominant expert takes most pairs: many tiles of one field, and
    every pair appears exactly once across the tiles."""
    rng = np.random.default_rng(4)
    m, e, tile = 3000, 6, 128
    ids = np.where(rng.random(m) < 0.9, 2, rng.integers(0, e, m))
    valid = rng.random(m) < 0.95
    payload = rng.normal(size=m).astype(np.float32)
    want, got = _dispatch_both(ids, valid, payload, e, tile)
    _assert_dispatch_equal(want, got)
    _, orig, src, exp, cnt, live, n_tiles = got
    seen = np.concatenate([to_np(orig)[s : s + c] for s, c in zip(to_np(src), to_np(cnt))])
    np.testing.assert_array_equal(np.sort(seen), np.arange(m))
    for t in range(n_tiles):
        lanes = to_np(orig)[to_np(src)[t] : to_np(src)[t] + to_np(cnt)[t]]
        owned = lanes[valid[lanes]]
        assert (ids[owned] == to_np(exp)[t]).all()
        assert owned.size == 0 or t < int(live)
