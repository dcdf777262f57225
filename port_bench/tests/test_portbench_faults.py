"""The whole run of a cell at a tiny size on the CPU, the card's look
skipped: sound, it comes out correct; with the timed path broken
underneath, the comparison catches each fault the cell can have. Besides
the cells, the stream's other frame input (decoded frames from memory) and
the single-view update mode, which a later cell asks for by data alone."""

import time

import pytest
import torch

from port_bench import manifest as mf
from port_bench import run
from port_bench.tests.tiny import tiny_cell

SEED = 2**31 + 11


VARIANTS = {"mv_replay": {}, "mv_render": {}, "memory": {"input": "memory"},
            "memory_sv": {"input": "memory", "update_mode": "single_view"}}


def _run(variant):
    workload = "mv_render" if variant == "mv_render" else "mv_replay"
    cfg, wl = tiny_cell(workload, **VARIANTS[variant])
    return run.run_cell(workload, cfg, wl, mf.load_manifest(), SEED, 1.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sound_run_is_correct(variant):
    res = _run(variant)
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0


def _state_unchanged(monkeypatch):
    from neural_graph_mapping_tpu_torch.mapping import optimizer

    monkeypatch.setattr(optimizer, "adam_slice_update", lambda *a, **k: None)


def _half_the_fields(monkeypatch):
    from neural_graph_mapping_tpu_torch.mapping import engine

    core = engine._optimization_iteration_core

    def half(fset, camera, rcfg, ocfg, loss_cfg, params, adam, ti, pos, ori, target, *rest, **kw):
        keep = torch.arange(target.field_valid.shape[0]) < target.field_valid.shape[0] // 2
        fv = target.field_valid & keep
        target = target._replace(field_valid=fv, rgb_mask=target.rgb_mask & fv[:, None],
                                 depth_mask=target.depth_mask & fv[:, None],
                                 term_mask=target.term_mask & fv[:, None])
        return core(fset, camera, rcfg, ocfg, loss_cfg, params, adam, ti, pos, ori, target, *rest, **kw)

    monkeypatch.setattr(engine, "_optimization_iteration_core", half)


def _loss_altered(monkeypatch):
    from neural_graph_mapping_tpu_torch.mapping import engine

    compute = engine.compute_losses

    def altered(*args, **kwargs):
        loss, terms = compute(*args, **kwargs)
        return loss, dict(terms, combined=terms["combined"] * 1.01)

    monkeypatch.setattr(engine, "compute_losses", altered)


@pytest.mark.parametrize("variant", ["mv_replay", "memory_sv"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_fields, _loss_altered])
def test_training_faults_are_not_correct(variant, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(variant)["correct"] is False


def test_a_training_fault_shows_in_the_render(monkeypatch):
    """The render cell's reference trains a map of its own, so a fault in
    the program's training of the map it renders from is not correct."""
    _state_unchanged(monkeypatch)
    assert _run("mv_render")["correct"] is False


def test_an_altered_pixel_is_not_correct(monkeypatch):
    from neural_graph_mapping_tpu_torch.mapping import engine

    block = engine.render_block_tiled

    def altered(*args, **kwargs):
        rgbd, dv, tp = block(*args, **kwargs)
        rgbd = rgbd.clone()
        rgbd[17, 1] += 0.05
        return rgbd, dv, tp

    monkeypatch.setattr(engine, "render_block_tiled", altered)
    assert _run("mv_render")["correct"] is False
