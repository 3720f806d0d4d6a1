"""Core state dataclasses and static configuration (torch port)."""
