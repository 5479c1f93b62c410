"""Host-side utilities (ported so far: ``audio``, WAV read and write)."""
