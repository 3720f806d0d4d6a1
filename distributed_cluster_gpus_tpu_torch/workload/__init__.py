"""Workload specs and the per-chunk arrival-table compiler (torch port)."""
