"""Static analyses (trimmed: the memory accounting, the memory verifier and
its diagnostics)."""
