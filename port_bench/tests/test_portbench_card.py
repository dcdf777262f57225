"""On the card: each cell's control (the reference computed with TF32
matrix products) fails the cell's limits where the program passes them, at
the cell's own size on one seed. ``python3 -m pytest port_bench/tests -m gpu``
on the card's machine; skipped here."""

import pytest

from port_bench import control
from port_bench import manifest as mf

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("workload", ["mv_render", "mv_replay", "mv_live"])
def test_the_control_fails_where_the_program_passes(workload, card):
    from neural_graph_mapping_tpu_torch.ops import cuda_build

    cuda_build.load_all()
    limits = mf.load_workload(workload)["check"]
    got = control.readings(workload, 7000000001, 2.0, "cuda")
    assert all(got["program"][k] <= lim for k, lim in limits.items()), got["program"]
    assert any(got["control"][k] > lim for k, lim in limits.items()), got["control"]
    if "half_batch" in got:  # the fault reads the numbers of the map it trains
        assert any(v > limits[k] for k, v in got["half_batch"].items() if k in limits), got["half_batch"]
