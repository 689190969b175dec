"""Utilities of the port: ``fault`` (retry with backoff)."""
