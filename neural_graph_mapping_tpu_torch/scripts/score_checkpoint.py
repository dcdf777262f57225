"""Score a checkpoint's held-out renders with the port: the run's final
render metrics (each held-out frame rendered at the sequence's last pose
estimate, as ``evaluate_full`` does), from a checkpoint of either package.

    python -m neural_graph_mapping_tpu_torch.scripts.score_checkpoint \\
        --config neural_graph_map.yaml synthetic.yaml [--key value ...] \\
        --checkpoint RUN.npz [--device cpu]

The config and its overrides are the run's (``run_mapping``'s syntax), so
the same frames are held out. Rendering a JAX checkpoint through the port
separates the fit from the render when the two packages' runs are compared.
Prints one JSON line: ``final_<metric>`` for each of ``eval_metrics``, the
held-out frames and the map's field count.
"""

from __future__ import annotations

import argparse
import json

from neural_graph_mapping_tpu_torch import config as config_mod
from neural_graph_mapping_tpu_torch.run_mapping import NeuralGraphMapRunner, mean_metric_dicts


def score(config: dict, checkpoint: str, device: str = "cuda") -> dict:
    """Load ``checkpoint`` into a runner of ``config`` and render its
    held-out frames -> metrics."""
    runner = NeuralGraphMapRunner(dict(config, eval_store_details=False), device=device)
    dataset = runner._dataset_type(runner._dataset_config)
    dataset.load_slam_results()
    runner.dataset = dataset
    runner.split_sequence(dataset)
    if not runner.eval_frame_ids:
        raise ValueError("the config holds out no frame (eval_ratio and the keyframes leave none)")
    runner.load_model(checkpoint)
    last = len(dataset) - 1
    metrics = mean_metric_dicts([runner.evaluate_frame(fid, last) for fid in sorted(runner.eval_frame_ids)])
    out = {f"final_{k}": v for k, v in metrics.items()}
    out.update(eval_frames=sorted(runner.eval_frame_ids), num_fields=runner.engine.num_fields)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--device", default="cuda")
    known, rest = parser.parse_known_args(argv)
    config = config_mod.load_config_from_args(rest, default_config=["neural_graph_map.yaml"])
    print(json.dumps(score(config, known.checkpoint, known.device), default=float))


if __name__ == "__main__":
    main()
