"""Chunked evaluation of large batches and the capacity route's drop
warning (port of neural_graph_mapping_tpu.utils.chunking)."""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch


def batched_evaluation(
    model: Callable,
    inputs: torch.Tensor,
    block_size: int,
    pass_offset: bool = False,
) -> Union[torch.Tensor, Tuple]:
    """Evaluate ``model`` over ``inputs`` in blocks along axis 0.

    The last block is padded with zeros to ``block_size`` and the padding is
    stripped from the outputs, so every block has one shape. With
    ``pass_offset`` the model is called as ``model(block, start_index)``
    (render blocks rebuild pixel ids from the offset in the kernel).
    """
    n = inputs.shape[0]
    pad = (-n) % block_size
    if pad:
        inputs = torch.cat([inputs, inputs.new_zeros((pad,) + tuple(inputs.shape[1:]))], dim=0)
    starts = range(0, n + pad, block_size)
    if pass_offset:
        outs = [model(inputs[s : s + block_size], s) for s in starts]
    else:
        outs = [model(inputs[s : s + block_size]) for s in starts]
    if isinstance(outs[0], tuple):
        return tuple(
            torch.cat(parts)[:n] if isinstance(parts[0], torch.Tensor) else parts
            for parts in zip(*outs)
        )
    return torch.cat(outs)[:n]


def warn_dropped_pairs(drop_counts, logger, what: str, capacity: int) -> int:
    """Sum the per-chunk dropped-pair counts of the capacity-buffer route
    (0-d tensors or ints; one host sync) and warn if any pair was dropped:
    the blend then renormalised over the survivors, which biases the
    outputs. Shared by render_image and meshing. Returns the total."""
    total = int(sum(int(d) for d in drop_counts))
    if total:
        logger.warning(
            "%s capacity path DROPPED %d KNN pairs (capacity %d too small under demand "
            "skew); outputs are biased where drops occurred. Use the tiled route or raise "
            "the capacity.",
            what, total, capacity,
        )
    return total


def save_image(img, file_path) -> None:
    """Save an (H, W, 3) [0, 1] array as a PNG."""
    import numpy as np
    import PIL.Image

    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)
    PIL.Image.fromarray(arr).save(file_path)
