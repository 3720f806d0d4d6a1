"""Physics, optimizer tables, PRNG and arrival samplers (torch port)."""
