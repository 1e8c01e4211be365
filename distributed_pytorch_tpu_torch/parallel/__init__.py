"""Process-group helpers."""
