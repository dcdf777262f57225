"""The port's auxiliary utilities on the CPU: the frame prefetcher (order,
fallback on a mismatch, worker exceptions, early close, device copies), the
``benchmark`` switch, ``ThroughputTracker``, the loggers' no-op without
their packages, ``save_image``, and the config CLI (the same configs as the
JAX package's parser, and config files written without PyYAML)."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from neural_graph_mapping_tpu import config as jconfig
from neural_graph_mapping_tpu_torch import config
from neural_graph_mapping_tpu_torch.utils import chunking, profiling
from neural_graph_mapping_tpu_torch.utils.observability import (
    RerunLogger, WandbLogger, prepare_dict_for_wandb,
)
from neural_graph_mapping_tpu_torch.utils.prefetch import FramePrefetcher


class _DS:
    """Counts reads; an item is its frame id and a seeded frame."""

    def __init__(self):
        self.reads = []

    def __getitem__(self, fid):
        self.reads.append(fid)
        rgbd = np.random.default_rng(fid).uniform(0, 1, (6, 8, 4)).astype(np.float32)
        return {"fid": fid, "rgbd": rgbd}


@pytest.mark.parametrize("to_device", [False, True])
def test_prefetch_in_order_delivery(to_device):
    ds = _DS()
    ids = [0, 2, 3, 7]
    pf = FramePrefetcher(ds, ids, depth=2, to_device=to_device, device="cpu")
    for fid in ids:
        item = pf.get(fid)
        assert item["fid"] == fid
        if to_device:
            assert isinstance(item["rgbd_dev"], torch.Tensor)
            np.testing.assert_array_equal(item["rgbd_dev"].numpy(), item["rgbd"])
        else:
            assert "rgbd_dev" not in item
    pf.close()
    assert ds.reads == ids


def test_prefetch_mismatch_falls_back_to_sync():
    ds = _DS()
    pf = FramePrefetcher(ds, [0, 1], depth=2, to_device=True, device="cpu")
    assert pf.get(5)["fid"] == 5  # out of schedule: served synchronously
    assert "rgbd_dev" not in pf.get(5)
    assert pf.get(0)["fid"] == 0
    assert pf.get(1)["fid"] == 1
    pf.close()


def test_prefetch_worker_exception_reraised():
    class Boom:
        def __getitem__(self, fid):
            raise ValueError("decode failed")

    pf = FramePrefetcher(Boom(), [0], depth=1)
    with pytest.raises(ValueError, match="decode failed"):
        pf.get(0)
    pf.close()


def test_prefetch_close_stops_early():
    """close() on an early abort reads at most the items in flight."""
    gate = threading.Event()

    class SlowDS:
        def __init__(self):
            self.reads = []

        def __getitem__(self, fid):
            if fid > 0:
                gate.wait(timeout=10.0)
            self.reads.append(fid)
            return {"fid": fid}

    ds = SlowDS()
    pf = FramePrefetcher(ds, list(range(50)), depth=1)
    assert pf.get(0)["fid"] == 0
    t0 = time.monotonic()
    pf._stop.set()
    gate.set()
    pf.close()
    assert time.monotonic() - t0 < 5.0
    assert len(ds.reads) <= 4


def test_benchmark_decorator_toggles(capsys):
    @profiling.benchmark
    def work():
        return torch.ones(4).sum()

    profiling.benchmark.enabled = False
    work()
    assert "finished" not in capsys.readouterr().out
    profiling.benchmark.enabled = True
    try:
        assert float(work()) == 4.0
        assert "work finished" in capsys.readouterr().out
    finally:
        profiling.benchmark.enabled = False


def test_throughput_tracker():
    t = profiling.ThroughputTracker()
    assert t.fps_estimate == 0.0 and t.spf_estimate == 0.0
    t.add_frame(0.5)
    t.add_frame(0.5)
    assert abs(t.fps_estimate - 2.0) < 1e-9
    assert abs(t.spf_estimate - 0.5) < 1e-9


class _Boom:
    def __getattr__(self, name):
        raise AssertionError(f"wandb.{name} was used")


def test_wandb_is_opt_in(monkeypatch):
    """Without ``enabled`` the logger never touches wandb (an installed wandb
    without credentials would raise in init and report the error online)."""
    monkeypatch.setitem(sys.modules, "wandb", _Boom())
    wl = WandbLogger("test", {"a": 1})
    assert not wl.enabled
    wl.log({"x": 1.0})
    wl.finish()


def test_loggers_degrade_to_no_ops(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises ImportError
    monkeypatch.setitem(sys.modules, "rerun", None)
    wl = WandbLogger("test", {"a": 1}, enabled=True)
    assert not wl.enabled
    wl.log({"x": 1.0})
    wl.log_image("k", "missing.png")
    wl.finish()
    rl = RerunLogger(spawn=False)
    assert not rl.enabled
    rl.set_frame(3)
    rl.log_fields(np.zeros((2, 3)), 1.0)
    rl.log_camera(np.eye(4), None)
    rl.log_mesh(None)


def test_prepare_dict_for_wandb():
    d = {"a": np.float32(1.5), "b": {"c": np.int64(3)}, "t": torch.tensor(2.5), "d": "x"}
    out = prepare_dict_for_wandb(d)
    assert type(out["a"]) is float and type(out["b"]["c"]) is int and out["t"] == 2.5


def test_save_image(tmp_path):
    import PIL.Image

    img = np.linspace(-0.5, 1.5, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    chunking.save_image(img, tmp_path / "x.png")
    got = np.asarray(PIL.Image.open(tmp_path / "x.png"))
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


ARGV = [
    "--config", "neural_graph_map.yaml", "synthetic.yaml",
    "--model_kwargs.num_knn", "3", "--learning_rate", "1e-3", "--eval_metrics", "[psnr, ssim]",
    "--render_vis=true", "--dataset_config.num_frames", "8", "--new.nested.key", "text",
]


def test_load_config_from_args_equals_jax():
    got = config.load_config_from_args(ARGV)
    assert got == jconfig.load_config_from_args(ARGV)
    assert got["model_kwargs"]["num_knn"] == 3 and got["learning_rate"] == 1e-3
    assert got["new"]["nested"]["key"] == "text" and got["render_vis"] is True
    with pytest.raises(ValueError):
        config.load_config_from_args(["--dangling"])


def test_overrides_parse_without_yaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert config._parse_override_value("3") == 3
    assert config._parse_override_value("1e-3") == 1e-3
    assert config._parse_override_value("[1, 2]") == [1, 2]
    assert config._parse_override_value("true") is True
    assert config._parse_override_value("psnr") == "psnr"
    assert config._parse_override_value("False") is False
    assert config._parse_override_value("True") is True
    assert config._parse_override_value("null") is None
    assert config._parse_override_value("~") is None
    assert config._parse_override_value("[psnr, ssim]") == ["psnr", "ssim"]


OVERRIDE_SPELLINGS = [
    "", "~", "null", "Null", "NULL", "True", "FALSE", "false", "yes", "No", "on", "Off", "y", "n",
    "3", "-3", "+3", "0", "-0", "1_000", "1.5", "1.", ".5", "-.5", "1e-3", "1.5e-3", "1.5E+3",
    ".inf", "-.Inf", ".NaN", "nan", "inf", "psnr", "a b", "a,b", "/tmp/x y", "--x", "a:b",
    "[psnr, ssim]", "[1, 2.5, [a, b]]", "[a, b,]", "[]", "{}", "[1,2]", "[a,b]", "[1e-3]",
    "[-1, +2, -.5]", "[null, ~, True, off]", "{a: 1, b: [x, y]}", "{a}", "{a: }", "{a:1}",
    "'x y'", "'it''s'", '"1e-3"', '"a\\"b"', "[ 'a, b', \"c]\" ]",
]


@pytest.mark.parametrize("have_yaml", [True, False])
@pytest.mark.parametrize("raw", OVERRIDE_SPELLINGS)
def test_override_spellings_equal_jax(monkeypatch, raw, have_yaml):
    """Every spelling parses to the JAX package's (PyYAML's) value, with or
    without PyYAML installed."""
    want = jconfig._parse_override_value(raw)
    if not have_yaml:
        monkeypatch.setitem(sys.modules, "yaml", None)
    got = config._parse_override_value(raw)
    assert type(got) is type(want)
    if isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want


@pytest.mark.parametrize(
    "raw", ["017", "0x1F", "00", "1:30", "2001-12-14", "&a x", "!!str 3", "a: b", "x #c", "-",
            "[a, b", "{a: 1", "'x", "[a] b", "[a: 1]", "[a b, c] d"]
)
def test_override_forms_not_read_raise(raw):
    with pytest.raises(ValueError):
        config._parse_override_value(raw)


@pytest.mark.parametrize("have_yaml", [True, False])
def test_save_config_to_file(tmp_path, monkeypatch, have_yaml):
    """The file is the same JSON text (which YAML readers take too) with or
    without PyYAML."""
    cfg = {"a": np.float32(0.5), "b": {"c": [1, np.int64(2)], "p": tmp_path}, "d": None,
           "t": torch.tensor(3)}
    want = {"a": 0.5, "b": {"c": [1, 2], "p": str(tmp_path)}, "d": None, "t": 3}
    if not have_yaml:
        monkeypatch.setitem(sys.modules, "yaml", None)
    config.save_config_to_file(tmp_path / "out" / "c.yaml", cfg)
    text = (tmp_path / "out" / "c.yaml").read_text()
    assert text == json.dumps(want, indent=2)
    assert yaml.safe_load(text) == want


def test_json_config_loads_without_yaml(tmp_path, monkeypatch):
    """A config written without PyYAML (JSON) reads back without it, with
    overrides, as the same dict the YAML files give."""
    want = config.load_config_from_args(["--config", "neural_graph_map.yaml", "synthetic.yaml"])
    monkeypatch.setitem(sys.modules, "yaml", None)
    config.save_config_to_file(tmp_path / "synthetic.json", want)
    got = config.load_config_from_args(["--config", str(tmp_path / "synthetic.json"), "--seed", "1"])
    assert got == dict(want, seed=1)
