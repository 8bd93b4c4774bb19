"""Spans and metrics (copied from the reference, stdlib only)."""
