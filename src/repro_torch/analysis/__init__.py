"""Static analysis of compiled programs (data types only, so far)."""
