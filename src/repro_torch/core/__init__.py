"""Pattern dictionaries, block-pattern sparse weights, quantization."""
