"""CNN configurations and the dense reference forward."""
