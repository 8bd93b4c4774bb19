"""PyTorch/CUDA port of the pattern-pruned RRAM-CNN engine.

A second package beside the JAX reference ``repro``: same module names,
same public layouts (NCHW images, ``[C_out, C_in, K, K]`` conv weights,
``[K, N]`` matmul views, ``w_comp [T, k_max, block, tile]``), so each
port module sits next to its counterpart.  It imports ``torch`` and
numpy, never ``jax`` and never ``repro``; the pure-numpy pieces it
needs are copied in.  The block-pattern spmm runs through hand-written
CUDA kernels for Hopper (``kernels/csrc/pattern_spmm.cu``).

Every entry point (``compile_network``, ``load_program``,
``make_forward``, ``execute``, ``InferenceService``) runs on ``cuda``
unless the caller passes ``device="cpu"``; with no device given and no
CUDA it raises instead of falling back.
"""
