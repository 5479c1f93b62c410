"""Window drivers, one per ``loop`` a traffic mix names: ``em`` (closed-loop
EM jobs) and ``align`` (closed-loop decode passes)."""
