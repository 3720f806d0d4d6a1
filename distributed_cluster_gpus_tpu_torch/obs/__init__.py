"""Run artifacts: the status summary (the exporters and telemetry are ROADMAP A12)."""
