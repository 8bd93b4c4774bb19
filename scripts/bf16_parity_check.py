#!/usr/bin/env python3
"""Where the port's bf16 language models part from the reference's, on
the CPU.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python3 scripts/bf16_parity_check.py

1. SiLU and GELU on 200,000 seeded bf16 values: the share of them on
   which ``torch.nn.functional.silu`` and ``gelu(approximate="tanh")``
   (rounded once) and ``models.layers.silu`` and ``models.layers.gelu``
   (``jax.nn.silu``'s and ``jax.nn.gelu``'s steps, each rounded) differ
   from ``jax.nn.silu`` and ``jax.nn.gelu``.
2. mamba2's smoke model in bf16: the logits of 40 seeded tokens from the
   reference jitted as XLA compiles it by default (float32 excess
   precision inside fusions), compiled with
   ``xla_allow_excess_precision=False``, and run op by op
   (``jax.disable_jit``, remat off), each against the port's.
3. jamba's smoke model in bf16 on the reference's MoE routes
   (``tests/test_torch_lm.py``'s ``_SameRoutes``), the reference compiled
   with ``xla_allow_excess_precision=False``: the port's logits with
   ``models.layers.silu`` and with ``F.silu`` in its place, and the
   largest router-probability gap where the port would route otherwise.
4. whisper's and paligemma's smoke models in bf16 (the GELU MLP; the
   same frames, the same patch prefix): the port's logits with
   ``models.layers.gelu`` and with ``F.gelu(approximate="tanh")`` in its
   place, each against the reference jitted as the tests run it.

Distances are max|d| / max(1, max|reference|), as the tests take them.
One JSON object on stdout.  Needs both packages, no GPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp
    import pytest
    import torch
    import torch.nn.functional as F

    import test_torch_lm as T
    from repro_torch.models import layers

    out = {}
    x = (3 * np.random.default_rng(0).normal(size=200_000)).astype(np.float32)
    want = np.asarray(jax.nn.silu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    xt = torch.from_numpy(x).bfloat16()
    out["silu_share_differing_from_jax"] = {
        name: float((fn(xt).float().numpy() != want).mean())
        for name, fn in (("F.silu", F.silu), ("layers.silu", layers.silu))}
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)), np.float32)

    def gelu_once(t):
        return F.gelu(t, approximate="tanh")

    out["gelu_share_differing_from_jax"] = {
        name: float((fn(xt).float().numpy() != want).mean())
        for name, fn in (("F.gelu", gelu_once), ("layers.gelu", layers.gelu))}

    def compiled(fn, statics, *args, excess: bool):
        call = jax.jit(lambda p, a: fn(p, statics, *a)).lower(*args[:1],
                                                                args[1:])
        opts = {} if excess else {"xla_allow_excess_precision": False}
        return call.compile(compiler_options=opts)(args[0], args[1:])

    toks = np.random.default_rng(5).integers(0, 512, (2, 40))
    jcfg = dataclasses.replace(T.CONFIGS["mamba2_780m"](), remat=False)
    _, jp, jst, _, tp, tst = T._models(jcfg, "bfloat16")
    port = T.ttr.apply_model(tp, tst, T._t(toks))[0].float().numpy()
    refs = {
        "jit_default": compiled(T.jtr.apply_model, jst, jp,
                                jnp.asarray(toks), excess=True)[0],
        "jit_no_excess_precision": compiled(
            T.jtr.apply_model, jst, jp, jnp.asarray(toks), excess=False)[0],
    }
    with jax.disable_jit():
        refs["op_by_op"] = T.jtr.apply_model(jp, jst, jnp.asarray(toks))[0]
    refs = {k: np.asarray(v, np.float32) for k, v in refs.items()}
    out["mamba2_smoke_bf16"] = {
        "port_vs": {k: T._rel(port, v) for k, v in refs.items()},
        "jit_default_vs_op_by_op": T._rel(refs["jit_default"],
                                          refs["op_by_op"])}

    jamba = {}
    for name, silu in (("layers.silu", layers.silu), ("F.silu", F.silu)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers, "silu", silu)
            mp.setattr(T.tmoe, "silu", silu)
            same = T._SameRoutes(mp)
            _, jp, jst, _, tp, tst = T._models(
                T.CONFIGS["jamba_1_5_large_398b"](), "bfloat16")
            ref = np.asarray(compiled(T.jtr.apply_model, jst, jp,
                                      jnp.asarray(toks), excess=False)[0],
                             np.float32)
            jax.effects_barrier()
            got = T.ttr.apply_model(tp, tst, T._t(toks))[0].float().numpy()
            jamba[name] = {"port_vs_reference": T._rel(got, ref),
                           "route_flips": same.flips,
                           "worst_router_gap": same.worst_gap}
    out["jamba_smoke_bf16"] = jamba

    for arch in ("whisper_small", "paligemma_3b"):
        _, jp, jst, _, tp, tst = T._models(T.CONFIGS[arch](), "bfloat16")
        jx, tx = T._extras(jst["cfg"], 2)
        ref = np.asarray(T.jtr.apply_model(jp, jst, jnp.asarray(toks),
                                           **jx)[0], np.float32)
        row = {}
        for name, gelu in (("layers.gelu", layers.gelu),
                           ("F.gelu", gelu_once)):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(layers, "gelu", gelu)
                got = T.ttr.apply_model(tp, tst, T._t(toks), **tx)[0]
            row[name] = T._rel(got.float().numpy(), ref)
        out[f"{arch}_smoke_bf16_port_vs_reference"] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
