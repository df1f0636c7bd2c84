"""Measurement tools of the port, twins of the JAX package's ``tools/``.

Each runs as ``python -m jincresize_tpu_torch.tools.<name>`` and has
``main(argv=None, size=None)``: ``size`` = (src_w, src_h, dst_w, dst_h)
overrides the geometry, so that tests and ``chip_smoke.py`` can run it small.
Each takes ``--device`` (default ``cuda``; raises when no card is visible)
and names the card (``nvidia-smi`` name and power limit) on stderr. Times
come from CUDA events; on ``--device cpu`` they are host-clock times of the
plain forms and say nothing of a card.

* ``device_loop_timing`` -- ``torch.zeros``, the ``out_only`` probe kernel,
  the fused interior and the full ``ConvApplier`` call at 8-frame 4K->8K,
  eager and, for the probe and the interior, as one CUDA-graph replay;
* ``fused_tile_sweep`` -- the fused kernel's thread-block shapes;
* ``assemble_breakdown`` -- interior, paste, strips and full applier call;
* ``bench_gather`` -- the general-geometry engines on crop-0.3 geometries;
* ``streaming_pipeline`` -- serialized against double-buffered uploads.
"""
