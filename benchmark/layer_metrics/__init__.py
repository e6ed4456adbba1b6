"""Readers of the per-layer metrics, one file each, named by the metric:
``read(ctx)`` returns the metric's value from the traced run's context, or
None where it finds nothing to read.  ``ctx`` holds the device events of
the traced window (``events``: ``(name, start ns, end ns)``), the host
spans (``spans``), the counts (``calls``, ``steps``, ``forwards``), the
window's seconds and the device's busy seconds, the model's FLOPs (from the
plain reference), the logical shapes the kernels' counts are taken on, the
peak of device memory and the number of chips."""
