"""A frozen copy of neural_graph_mapping_tpu_torch's plain PyTorch paths.

The modules here are the port's own, copied but for their import prefix
and cut to what the benchmark's reference runs: one unsharded map trained
online (multi- or single-view) and rendered on the tiled route. Every kernel
wrapper in ``ops/permuto_cuda.py`` and ``ops/topk.py`` is its plain
version, on whatever device the tensors lie; nothing is built or launched.
``config.py`` resolves the configuration's type names to this copy's
classes. The reference imports nothing of the program, so a later change
to the program leaves the yardstick where it is.
"""
