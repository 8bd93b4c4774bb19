"""The placed serving steps (``runtime.serve``'s ``make_prefill_step`` /
``make_decode_step`` with ``shardings=``) against the JAX reference
(CPU).

On spawned ``gloo`` ranks (1 x 2 and 2 x 2 ``(data, model)`` meshes,
``tests/torch_mesh_worker.py``'s ``placed_serve`` job), each rank holding
only its slabs of the params (``launch.steps.param_shardings``) and of a
float32 cache (``launch.steps.cache_shardings``: batch over ``data``,
positions over ``model``), a placed prefill of 4 prompts of 15 tokens and
3 greedy decode steps (positions 15 to 17, across the boundary of the two
position slabs of a 32-slot cache) for granite, h2o-danube (window 16),
mamba2 (conv and state), DeepSeek-V2 (MLA latents; MoE capacity over the
whole batch), whisper (the encoder's memory) and granite with
``decode_strategy="flash"`` (``models.attention.flash_decode_placed``):

  * every rank's rows' tokens are the reference's unsharded greedy tokens;
  * its decode logits lie within 1e-6 of the port's unsharded ones,
    relative to their largest;
  * it holds exactly the bytes its placements reckon.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as jtr
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.runtime.serve import make_decode_step as j_decode
from repro.runtime.serve import make_prefill_step as j_prefill

from repro_torch.models import transformer as ttr
from repro_torch.models.convert import lm_params_from_numpy
from test_torch_sharded import _run_ranks

LOGITS_REL = 1e-6


BATCH, PROMPT, MAX_SEQ, STEPS = 4, 15, 32, 3
SERVED = {  # name -> (arch, overrides, reference key)
    "granite": ("granite_3_2b", {}, 0),
    "danube": ("h2o_danube_1_8b", {}, 1),
    "mamba2": ("mamba2_780m", {}, 2),
    "deepseek_v2": ("deepseek_v2_236b", {}, 3),
    "whisper": ("whisper_small", {}, 4),
    "granite_flash": ("granite_3_2b", {"decode_strategy": "flash"}, 0),
}


@pytest.fixture(scope="module")
def served():
    """Per model: the numpy params, prompts (and frames), the reference's
    unsharded greedy tokens, and the port's unsharded decode logits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime.serve import (
        ServeConfig,
        decode_logits,
        make_prefill_step,
    )

    torch.set_num_threads(1)
    out = {}
    for name, (arch, over, seed) in SERVED.items():
        jcfg = dataclasses.replace(j_smoke(arch), **over)
        jp, _, jst = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
        params = jax.tree.map(np.asarray, jp)
        rng = np.random.default_rng(seed)
        toks = rng.integers(1, jcfg.vocab, (BATCH, PROMPT)).astype(np.int32)
        frames = (rng.normal(size=(BATCH, jcfg.enc_seq, jcfg.d_model))
                  .astype(np.float32) if jcfg.encoder_layers else None)
        extras = {"frames": jnp.asarray(frames)} if frames is not None \
            else None
        jscfg = JServeConfig(max_seq=MAX_SEQ, cache_dtype="float32")
        jc = jtr.init_cache(jst, BATCH, MAX_SEQ, dtype=jnp.float32)
        jt, jc = jax.jit(j_prefill(jcfg, jst, jscfg))(
            jp, jc, jnp.asarray(toks), extras)
        ref = [np.asarray(jt)]
        jdec = jax.jit(j_decode(jcfg, jst, jscfg))
        for i in range(STEPS):
            jt, jc = jdec(jp, jc, jt, jnp.int32(PROMPT + i))
            ref.append(np.asarray(jt))
        # the port, unsharded: the logits the placed steps are held to
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        tst = ttr.init_statics(cfg, "cpu")
        tp = lm_params_from_numpy(params, "cpu")
        tc = ttr.init_cache(tst, BATCH, MAX_SEQ, dtype=torch.float32)
        with torch.no_grad():
            tok, tc = make_prefill_step(cfg, tst, ServeConfig(
                max_seq=MAX_SEQ, cache_dtype="float32"))(
                tp, tc, torch.as_tensor(toks, dtype=torch.long),
                {"frames": torch.from_numpy(frames)}
                if frames is not None else None)
            logits = []
            for i in range(STEPS):
                lg, tc = decode_logits(tst, tp, tc, tok,
                                       torch.tensor(PROMPT + i))
                tok = lg.argmax(dim=-1)
                logits.append(lg.numpy())
        out[name] = {"arch": arch, "over": over, "params": params,
                     "tokens": toks, "frames": frames, "ref": ref,
                     "logits": logits}
    return out


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_placed_serving_matches_reference(served, mesh, tmp_path):
    jobs = [{"kind": "placed_serve", "name": name, "arch": m["arch"],
             "overrides": m["over"], "mesh": mesh, "params": m["params"],
             "tokens": m["tokens"], "frames": m["frames"],
             "max_seq": MAX_SEQ, "steps": STEPS}
            for name, m in served.items()]
    ranks = _run_ranks(tmp_path, math.prod(mesh), jobs)
    for name, m in served.items():
        rows = {}
        for res in ranks:
            r = res[name]
            assert r["resident_bytes"] == r["reckoned_bytes"], name
            lo, hi = r["rows"]
            for step, tok in enumerate(r["tokens"]):
                np.testing.assert_array_equal(
                    tok, np.asarray(m["ref"][step])[lo:hi],
                    err_msg=f"{name} step {step}")
            for step, lg in enumerate(r["logits"]):
                want = m["logits"][step][lo:hi]
                rel = np.abs(lg - want).max() / np.abs(want).max()
                assert rel <= LOGITS_REL, (name, step, rel)
            rows[(lo, hi)] = True
            if name == "granite_flash":
                assert r["flash_calls"] == STEPS * 2  # two layers a step
            else:
                assert r["flash_calls"] == 0
        assert min(lo for lo, _ in rows) == 0
        assert max(hi for _, hi in rows) == BATCH
