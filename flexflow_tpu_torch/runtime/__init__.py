"""Runtime supervision (trimmed: the seeded fault schedule and the window
watchdog) and the CUDA-graph capture of step and decode windows."""
