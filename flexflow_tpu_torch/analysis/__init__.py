"""Static analyses (trimmed: the serving memory accounting)."""
