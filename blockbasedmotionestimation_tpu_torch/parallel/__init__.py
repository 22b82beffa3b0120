"""Row tiling with halo exchange, frame-pair batching and the multi-process
runtime (``tiled``, ``multihost``)."""
