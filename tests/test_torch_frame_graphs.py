"""The frame step's CUDA-graph segments (mapping/frame_graphs.py) on the CPU.

The CPU cannot record a graph, so the recorder is replaced by an eager
stand-in with a graph's data flow: a recorded segment runs its function
again at each replay, and its outputs land in the tensors of its first run,
which the later segments read. The segmented iterations (pre, the eager
encode, post, Adam; the observed test; a DrawSource's draws and the
single-view parity copied into fixed buffers; a new key's eager first
iteration) must then train a map bit for bit as the engine's eager
iterations do, through a capacity growth, also where the map's ``_graphs``
is set to None mid-run and it trains on eagerly. The card holds the real
graphs against the eager step (``tests/test_torch_gpu.py``)."""

import pytest
import torch

from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine, frame_graphs
from neural_graph_mapping_tpu_torch.utils import profiling
from port_bench import traffic
from test_torch_tracing import DS_CFG, tiny_config


class _EagerRecord:
    """A graph's stand-in: ``fn`` runs at each replay; its outputs are the
    first run's tensors, rebound to each later run's values."""

    def __init__(self, fn) -> None:
        self.fn, self.outputs = fn, None

    def replay(self) -> None:
        out = self.fn()
        if self.outputs is None:
            self.outputs = out
            return
        for fixed, new in zip(torch.utils._pytree.tree_leaves(self.outputs), torch.utils._pytree.tree_leaves(out)):
            fixed.set_(new)


@pytest.fixture
def eager_recorders(monkeypatch):
    monkeypatch.setattr(frame_graphs.FrameGraphs, "_record", lambda self, fn, warm=True, draws=False: _EagerRecord(fn))
    monkeypatch.setattr(profiling, "tracing_on", lambda: True)  # counters on, no profiler
    profiling.reset()
    yield
    profiling.reset()


def _map(cfg, draws: bool, graphed: bool):
    ngm = engine.NeuralGraphMap(cfg, "cpu", draws=traffic.SeededDraws(7, cfg, "cpu") if draws else None)
    assert ngm._graphs is None  # the CPU path trains eagerly
    if graphed:
        ngm._graphs = frame_graphs.FrameGraphs(ngm._fset, ngm._rcfg, ngm._ocfg, ngm._loss_cfg, ngm._step_generator,
                                               "cpu")
    return ngm


@pytest.mark.parametrize("draws,eager_from", [(True, None), (False, None), (True, 9)],
                         ids=["draw_source", "generator", "draw_source-eager_from_9"])
@pytest.mark.parametrize("mode", ["multi_view", "single_view"])
def test_segmented_iterations_train_as_the_eager_ones(eager_recorders, monkeypatch, mode, draws, eager_from):
    """With ``eager_from``, the segmented map's ``_graphs`` is set to None
    before that frame: it then trains on eagerly, as the other map does."""
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    cfg = tiny_config(update_mode=mode)
    segmented, eager = _map(cfg, draws, True), _map(cfg, draws, False)
    warm = []
    real = frame_graphs.FrameGraphs.iteration

    def hooked(self, camera, maps, targets, inputs, draws, eager_iteration):
        return real(self, camera, maps, targets, inputs, draws,
                    lambda: warm.append(segmented.capacity) or eager_iteration())

    monkeypatch.setattr(frame_graphs.FrameGraphs, "iteration", hooked)
    caps = set()
    for f in range(DS_CFG["num_frames"]):
        if f == eager_from:
            segmented._graphs = None
        assert segmented.process_frame(ds, f, ds[f]["rgbd"]) == eager.process_frame(ds, f, ds[f]["rgbd"]), f
        if segmented._graphs is not None:
            caps.add(segmented.capacity)
    for k in segmented._params:
        assert torch.equal(segmented._params[k], eager._params[k]), k
        assert torch.equal(segmented._adam.m[k], eager._adam.m[k])
        assert torch.equal(segmented._adam.v[k], eager._adam.v[k])
    assert torch.equal(segmented._adam.steps, eager._adam.steps)
    assert torch.equal(segmented._map_arrays.training_iterations, eager._map_arrays.training_iterations)
    # one eager iteration a key: the first capacity's and each growth's
    assert len(caps) >= 2 and warm == sorted(caps)
    c = profiling.counters()
    per_frame = cfg["num_iterations_per_frame"]
    graphed = per_frame * (DS_CFG["num_frames"] if eager_from is None else eager_from) - len(warm)
    iters = 2 * per_frame * DS_CFG["num_frames"]  # both maps count
    assert c["step.iterations"] == iters and c["step.graphed"] == graphed
    if mode == "single_view":
        assert c["sv.slots"] == cfg["num_train_fields"] * iters
