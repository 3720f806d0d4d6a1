"""Rollout lanes: R independent simulated worlds in one lane-stacked state."""
