"""Host-side utilities: JSON artifacts, signals, logging, checks, checkpoints."""
