#!/usr/bin/env python3
"""Float32 error of the chunked SSD scan against a token-by-token
recurrence, the reference's and the port's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/ssd_chunk_error.py

One Mamba-2 layer at mamba2-780m's width (d_model 1536, 48 heads of 64,
d_state 128), weights from ``repro.models.ssm.ssm_init`` (key 0), on
seeded inputs [1, 1000, 1536], at chunks of 128 (the published one) and
16.  The chunked scan of ``repro.models.ssm.ssm_apply`` (JAX) and of
``repro_torch.models.ssm.ssm_apply``, each against
``chip_smoke.ssd_recurrence`` on the same params and inputs: the worst
ratio to ``tests/test_models.py``'s elementwise bound (1e-5 + 1e-4 x
|recurrence|) and max|d| / max|recurrence|.  The chunked form's decay
``exp(cum_i - cum_j)`` differences two cumulative sums that reach
hundreds over a chunk, so its float32 error grows with the chunk and is
absolute at the tensor's scale.  One JSON object on stdout.  Needs both
packages, no GPU.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    from repro_torch.models.convert import lm_params_from_numpy

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    x = np.random.default_rng(0).normal(size=(1, 1000, 1536)).astype(
        np.float32)
    out = {}
    for chunk in (128, 16):
        jcfg = jssm.SSMConfig(d_model=1536, d_state=128, head_dim=64,
                              chunk=chunk, model_shards=16)
        tcfg = tssm.SSMConfig(**dataclasses.asdict(jcfg))
        params, _ = jssm.ssm_init(jax.random.PRNGKey(0), jcfg)
        tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
        with torch.no_grad():
            ref = cs.ssd_recurrence(tparams, tcfg,
                                    torch.from_numpy(x))[0].numpy()
            port = tssm.ssm_apply(tparams, tcfg, torch.from_numpy(x),
                                  tssm.init_ssm_cache(tcfg, 1))[0].numpy()
        jax_out = np.asarray(jssm.ssm_apply(params, jcfg, jnp.asarray(x),
                                            jssm.init_ssm_cache(jcfg, 1))[0])
        out[f"chunk_{chunk}"] = {
            name: {
                "worst_over_elementwise_bound": float(
                    (np.abs(got - ref)
                     / (cs.SSD_ATOL + cs.SSD_RTOL * np.abs(ref))).max()),
                "max_abs_diff": float(np.abs(got - ref).max()),
                "rel_to_max": float(np.abs(got - ref).max()
                                    / np.abs(ref).max()),
            }
            for name, got in (("reference_jax", jax_out), ("port", port))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
