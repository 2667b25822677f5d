"""Checkpoints and bitwise resume (checkpoint.py, integrity.py, retry.py),
the fit loop's and the serving engine's supervision (the seeded fault
sites, the window watchdog, the fault channel, the chaos soak), the
CUDA-graph capture of step and decode windows, and the multi-process
runtime (process initialization, rank-only feeding, one search for every
rank). The recompiles come with A8 part 2."""
