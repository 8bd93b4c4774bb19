"""Serving request/response contract (copied from the reference)."""
