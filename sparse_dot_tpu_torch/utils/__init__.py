"""Debug and tracing helpers."""
