"""Event engine, heuristic decisions and the host run loop (torch port)."""
