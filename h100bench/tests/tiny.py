"""A network small enough for the CPU, with the benchmark's layer kinds.

Its ``max_logit_err`` limit sits between what the program's plain CPU
path reads against the float64 reference (about 2e-7) and what the TF32
control reads (about 8e-4), as the full configurations' limits do.
"""

TINY = {
    "name": "tiny",
    "conv_channels": [[3, 8], [8, 16], [16, 16]],
    "pool_after": [2],
    "kernel": 3,
    "input_hw": 8,
    "num_classes": 5,
    "table_ii": {"sparsity": 0.8, "zero_pattern_ratio": 0.3,
                 "patterns_per_layer": [2, 3, 3]},
    "pattern_seed": 0,
    "engine": {"block": 128, "tile": 128, "precision": "fp32",
               "mapping": "fixed"},
    "service": {"batch_slots": 4},
    "limits": {"max_logit_err": 1e-5},
}

BACKLOG = {"arrivals": "backlog", "backlog_batches": 2,
           "image_pool_batches": 2}
OPEN = {"arrivals": "open", "rate_per_s": 200.0, "gap_cv": 1.0,
        "gap_seed": 0, "image_pool_batches": 2}
