"""Host-side utilities: ``audio`` (WAV read and write), ``checkpoint``
(parameter trees with ``torch.save``), ``profiling`` (the ``mwd.*``
spans, ``torch.profiler`` traces) and ``plotting`` (matplotlib figures)."""
