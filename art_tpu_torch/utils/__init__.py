"""Output helpers."""
