"""Runtime supervision (trimmed: the seeded fault schedule and the window
watchdog)."""
