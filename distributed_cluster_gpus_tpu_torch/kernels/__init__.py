"""Hand-written CUDA kernels: build/load helpers and per-kernel wrappers."""
