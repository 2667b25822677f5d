"""Runtime supervision (trimmed: the seeded fault schedule and the window
watchdog), the CUDA-graph capture of step and decode windows, and the
multi-process runtime (process initialization, rank-only feeding, one
search for every rank)."""
