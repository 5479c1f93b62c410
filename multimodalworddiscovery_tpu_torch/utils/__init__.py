"""Host-side utilities: ``audio`` (WAV read and write), ``checkpoint``
(parameter trees with ``torch.save``), ``profiling`` (``torch.profiler``
traces, timing) and ``plotting`` (matplotlib figures)."""
