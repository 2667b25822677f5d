"""Run telemetry (trimmed: the JSONL run-event stream)."""
