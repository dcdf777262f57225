"""Operation and byte counts against hand sums at small shapes."""

import pytest
import torch

from port_bench import counts


def test_encode_fwd_counts():
    table = torch.zeros(3, 2, 16, 64)  # 3 fields, L = 16, T = 64
    coords = torch.zeros(3, 3, 10)  # 10 points a field
    c = counts.encode_fwd(table, coords)
    assert c["bytes"] == (3 * 2 * 16 * 64 + 3 * 3 * 10 + 3 * 32 * 10) * 4
    assert c["ops"] == 30 * 16 * 128
    assert c["points"] == 30


def test_encode_bwd_table_counts_live_cotangents_only():
    coords = torch.zeros(2, 3, 5)
    g = torch.zeros(2, 2 * 4, 5)  # L = 4, rows 2l + f
    g[0, 0, 0] = 1.0  # point 0, level 0, feature 0
    g[0, 1, 0] = 2.0  # the same (point, level), feature 1: one live pair
    g[1, 7, 4] = -1.0  # field 1, point 4, level 3, feature 1
    c = counts.encode_bwd_table(coords, g, 4, 32)
    assert c["bytes"] == (2 * 3 * 5 + 2 * 8 * 5 + 2 * 2 * 4 * 32) * 4
    assert int(c["ops"]) == 2 * (128 + 16)


def test_moe_rays_and_routed_pairs():
    from neural_graph_mapping_tpu_torch.ops import dispatch

    ids = torch.tensor([0, 2, 2, 5, 1, 2])
    valid = torch.tensor([True, True, False, True, False, True])
    out = dispatch.tiled_dispatch_sorted(ids, valid, (torch.zeros(6),), 6, 2)
    pairs, experts = counts.routed_pairs(valid, out[3], out[4], out[5], 6)
    assert int(pairs) == 4 and int(experts) == 3  # fields 0, 2, 5
    c = counts.moe_rays(3, 3, 16, 64)
    assert c["bytes"] == 3 * 8 + 3 * 2 * 16 * 64 * 4 + 3 * 32 * 4
    assert c["ops"] == 3 * (16 * 128 + 40)


def test_mlp_flops_and_least_time():
    assert counts.mlp_flops([32, 32, 4]) == (2 * (32 * 32 + 32 * 4), 4 * (32 * 32 + 32 * 4))
    assert counts.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert counts.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert counts.share_pct(1.0, 4.0) == 25.0
    assert counts.share_pct(1.0, 0.0) is None
