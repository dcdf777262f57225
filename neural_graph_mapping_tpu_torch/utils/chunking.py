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
    """Save an (H, W, 3) [0, 1] array as a PNG (``utils/imageio``, no PIL:
    decoded, the same bytes as the JAX package's PIL-written file)."""
    import numpy as np

    from neural_graph_mapping_tpu_torch.utils import imageio

    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)
    imageio.write_png(file_path, arr)


def format_table(rows, headers) -> str:
    """``tabulate.tabulate(rows, headers)`` (its default "simple" format)
    for rows of a string and floats, without tabulate: strings left-aligned,
    floats in ``format(x, "g")`` aligned on their decimal point (on the
    exponent's "e" where there is no point; integers and nan end at the
    column's last digit before it), a column at least its header's width
    plus 2, numeric headers right-aligned, columns two spaces apart, a
    dashed rule under the header."""
    cols = []
    for c, header in enumerate(headers):
        values = [row[c] for row in rows]
        if all(isinstance(v, str) for v in values):
            cells = list(values)
            width = max([len(header) + 2] + [len(s) for s in cells])
            cols.append(([s.ljust(width) for s in cells], header.ljust(width), width))
            continue
        cells = [format(float(v), "g") for v in values]
        after = [_after_point(s) for s in cells]
        cells = [s + " " * (max(after) - a) for s, a in zip(cells, after)]
        width = max([len(header) + 2] + [len(s) for s in cells])
        cols.append(([s.rjust(width) for s in cells], header.rjust(width), width))
    lines = ["  ".join(h for _, h, _ in cols), "  ".join("-" * w for _, _, w in cols)]
    lines += ["  ".join(cells[r] for cells, _, _ in cols) for r in range(len(rows))]
    return "\n".join(line.rstrip() for line in lines)


def _after_point(s: str) -> int:
    """Characters after the decimal point (or, without one, the exponent's
    "e") of a formatted float; -1 for an integer, nan or inf."""
    if s.lstrip("-").isdigit():
        return -1
    pos = s.rfind(".")
    pos = s.lower().rfind("e") if pos < 0 else pos
    return len(s) - pos - 1 if pos >= 0 else -1
