"""The placed serving steps (``runtime.serve``'s ``make_prefill_step`` /
``make_decode_step`` with ``shardings=``) against the JAX reference
(CPU).

On spawned ``gloo`` ranks (1 x 2 and 2 x 2 ``(data, model)`` meshes, and
a 2 x 1 x 2 ``(pod, data, model)`` one whose pods split the rows and
share what each wrote of the cache, ``tests/torch_mesh_worker.py``'s
``placed_serve`` job), each rank holding only its slabs of the params
(``launch.steps.param_shardings``) and of a float32 cache
(``launch.steps.cache_shardings``: batch over ``data``, positions over
``model``) and computing on them over ``model``, a placed
prefill of 4 prompts and 3 greedy decode steps (across the boundary of
the two position slabs of a 32-slot cache where the prompt is 15
tokens) for granite, h2o-danube (window 16), mamba2 (conv and state),
DeepSeek-V2 (MLA latents; MoE capacity each data block's), whisper
(the encoder's memory), granite with ``decode_strategy="flash"``
(``models.attention.flash_decode_placed``), phi3 (6 query heads over 3
key heads: key heads re-laid out, written by one rank and read by two),
paligemma with its 8-patch prefix (one key head every rank reads; a
prompt of 16 makes 24 positions, which split along the sequence), jamba
(attention, the SSM and MoE in one model; 16 positions, split), and
granite with 3 heads and mamba2 with 3 SSM heads, whose blocks do not
divide over 2 ranks and compute whole on their gathered slabs:

  * every rank's rows' tokens are the reference's unsharded greedy tokens
    (the MoE models', ``MOE``, where the rows split into data blocks: of
    each block's rows alone, as the reference's placed steps count
    capacity under its mesh);
  * its decode logits lie within ``LOGITS_REL`` (``BARS`` for phi3 and
    jamba) of the port's unsharded ones (so cut), relative to their largest
    (mamba2's and jamba's: of the unsharded run with the placed steps'
    two-half row sums, ``SPLIT_HELD``);
  * it holds exactly the bytes its placements reckon;
  * each step's collective bytes (``step.comm``) are those
    ``parallel.tensor.serve_bytes`` reckons for the rank, and the last
    decode's collectives by kind (``launch.op_stats``) theirs;
  * no param leaf that ``parallel.tensor.slab_leaves`` keeps on its slab
    is ever gathered.

``test_serve_bytes_equal_op_stats_on_a_fake_mesh`` holds the reckoning
to ``launch.op_stats`` over a fake 2 x 4 mesh (no ranks spawned) for a
prefill and a decode on both decode routes, and
``test_serve_bytes_over_pods_equal_op_stats_on_a_fake_mesh`` over a fake
2 x 2 x 4 ``(pod, data, model)`` one, and
``test_serve_bytes_where_moe_counts_the_whole_batch`` there with 2 rows,
which do not divide over pod x data.
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
from torch_mesh_worker import with_overrides

LOGITS_REL = 1e-6
# A row product over ``model`` (attention's ``wo``, the MLP's ``down``, the
# SSM's ``out_proj`` and its gated norm's sum of squares over ``d_inner``)
# sums each rank's float32 part, where the unsharded run sums all of its
# rows in one float32 order: for these models that alone moves the
# unsharded logits above ``LOGITS_REL`` (``test_split_row_sums_move_the_
# unsharded_logits``, within ``SPLIT_GAP``; ``_split_logits``).
SPLIT = ("jamba", "mamba2", "phi3")
SPLIT_GAP = 3e-6
# mamba2 is held at ``LOGITS_REL`` to the unsharded run with the placed
# steps' two-half sums (measured: 5.5e-7); the plain unsharded run is
# 1.68e-6 away.  jamba is held at its bar (``BARS``) to the same run.
SPLIT_HELD = ("mamba2", "jamba")
# The new models' bars, measured on this route (largest over the meshes,
# ranks and steps): phi3 1.24e-6 from the plain unsharded run (1.31e-6
# from the two-half run: the row sums do not account for it all); jamba
# 2.71e-6 from the two-half run of each data block's rows (1.70e-6 on
# 1 x 2, whose one block is the batch; the plain run of each block is
# 3.56e-6 away on 2 x 2, 2.32e-6 on 1 x 2).
BARS = {"phi3": 3e-6, "jamba": 3e-6}

BATCH, PROMPT, MAX_SEQ, STEPS = 4, 15, 32, 3
# the models whose MoE capacity couples rows, and the data blocks (each
# counted alone) each mesh cuts the batch into
MOE = ("deepseek_v2", "jamba")
BLOCKS = {(1, 2): 1, (2, 2): 2, (2, 1, 2): 2}
EXCHANGED = {"granite", "danube", "granite_flash", "phi3", "paligemma",
             "jamba", "whisper"}
SERVED = {  # name -> (arch, overrides, reference key, prompt tokens)
    "granite": ("granite_3_2b", {}, 0, PROMPT),
    "danube": ("h2o_danube_1_8b", {}, 1, PROMPT),
    "mamba2": ("mamba2_780m", {}, 2, PROMPT),
    "deepseek_v2": ("deepseek_v2_236b", {}, 3, PROMPT),
    "whisper": ("whisper_small", {}, 4, PROMPT),
    "granite_flash": ("granite_3_2b", {"decode_strategy": "flash"}, 0,
                      PROMPT),
    "phi3": ("phi3_medium_14b", {}, 5, PROMPT),
    "paligemma": ("paligemma_3b", {}, 6, 16),
    "jamba": ("jamba_1_5_large_398b", {}, 7, 16),
    # blocks whose heads do not divide over 2 ranks compute whole on the
    # cache gathered over model: 3 attention heads (their projections'
    # slabs gathered), and 3 SSM heads (the conv's slabs and the state)
    "granite_whole": ("granite_3_2b", {"n_heads": 3, "n_kv_heads": 3}, 8,
                      PROMPT),
    "mamba2_whole": ("mamba2_780m", {"ssm": {"expand": 3, "head_dim": 64}},
                     9, PROMPT),
}


def _unsharded(jcfg, jp, jst, cfg, params, toks, extras):
    """The reference's unsharded greedy tokens (prefill, then ``STEPS``
    decode steps) and the port's unsharded decode logits of the rows
    ``toks`` (and ``extras``)."""
    from repro_torch.runtime.serve import (
        ServeConfig,
        decode_logits,
        make_prefill_step,
    )

    b = toks.shape[0]
    total = toks.shape[1] + jcfg.prefix_len
    jscfg = JServeConfig(max_seq=MAX_SEQ, cache_dtype="float32")
    jc = jtr.init_cache(jst, b, MAX_SEQ, dtype=jnp.float32)
    jt, jc = jax.jit(j_prefill(jcfg, jst, jscfg))(
        jp, jc, jnp.asarray(toks), None if extras is None else
        {k: jnp.asarray(v) for k, v in extras.items()})
    ref = [np.asarray(jt)]
    jdec = jax.jit(j_decode(jcfg, jst, jscfg))
    for i in range(STEPS):
        jt, jc = jdec(jp, jc, jt, jnp.int32(total + i))
        ref.append(np.asarray(jt))
    # the port, unsharded: the logits the placed steps are held to
    tst = ttr.init_statics(cfg, "cpu")
    tp = lm_params_from_numpy(params, "cpu")
    tc = ttr.init_cache(tst, b, MAX_SEQ, dtype=torch.float32)
    with torch.no_grad():
        tok, tc = make_prefill_step(cfg, tst, ServeConfig(
            max_seq=MAX_SEQ, cache_dtype="float32"))(
            tp, tc, torch.as_tensor(toks, dtype=torch.long),
            None if extras is None else
            {k: torch.from_numpy(v) for k, v in extras.items()})
        logits = []
        for i in range(STEPS):
            lg, tc = decode_logits(tst, tp, tc, tok, torch.tensor(total + i))
            tok = lg.argmax(dim=-1)
            logits.append(lg.numpy())
    return ref, logits


@pytest.fixture(scope="module")
def served():
    """Per model: the numpy params, prompts (and frames), the reference's
    unsharded greedy tokens, and the port's unsharded decode logits (of
    ``SPLIT``'s, also those with two-half row sums); of ``MOE``'s, also
    both (``"blocks"``) of each half of the rows alone, concatenated."""
    from repro_torch.configs import get_smoke_config

    torch.set_num_threads(1)
    out = {}
    for name, (arch, over, seed, prompt) in SERVED.items():
        jcfg = with_overrides(j_smoke(arch), over)
        jp, _, jst = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
        params = jax.tree.map(np.asarray, jp)
        rng = np.random.default_rng(seed)
        toks = rng.integers(1, jcfg.vocab, (BATCH, prompt)).astype(np.int32)
        frames = (rng.normal(size=(BATCH, jcfg.enc_seq, jcfg.d_model))
                  .astype(np.float32) if jcfg.encoder_layers else None)
        prefix = (rng.normal(size=(BATCH, jcfg.prefix_len, jcfg.d_model))
                  .astype(np.float32) if jcfg.prefix_len else None)
        extras = ({"frames": frames} if frames is not None else
                  {"prefix_embeds": prefix} if prefix is not None else None)
        cfg = with_overrides(get_smoke_config(arch), over)
        ref, logits = _unsharded(jcfg, jp, jst, cfg, params, toks, extras)
        out[name] = {"arch": arch, "over": over, "params": params,
                     "tokens": toks, "frames": frames, "prefix": prefix,
                     "ref": ref, "logits": logits}
        if name in MOE:
            half = BATCH // 2
            parts = [_unsharded(jcfg, jp, jst, cfg, params,
                                toks[i:i + half], None if extras is None
                                else {k: v[i:i + half]
                                      for k, v in extras.items()})
                     for i in (0, half)]
            out[name]["blocks"] = {key: [np.concatenate(steps) for steps in
                                         zip(*(p[j] for p in parts))]
                                   for j, key in enumerate(("ref",
                                                            "logits"))}
        if name in SPLIT:
            out[name]["split_logits"] = _split_logits(cfg, params, toks)
        if name in SPLIT and name in MOE:
            out[name]["blocks"]["split_logits"] = [
                np.concatenate(steps) for steps in zip(*(
                    _split_logits(cfg, params, toks[i:i + BATCH // 2])
                    for i in (0, BATCH // 2)))]
    return out


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (2, 1, 2)])
def test_placed_serving_matches_reference(served, mesh, tmp_path):
    from repro_torch.parallel.tensor import serve_comm_by_kind

    jobs = [{"kind": "placed_serve", "name": name, "arch": m["arch"],
             "overrides": m["over"], "mesh": mesh, "params": m["params"],
             "tokens": m["tokens"], "frames": m["frames"],
             "prefix": m["prefix"], "max_seq": MAX_SEQ, "steps": STEPS}
            for name, m in served.items()]
    ranks = _run_ranks(tmp_path, math.prod(mesh), jobs)
    for name, m in served.items():
        rows = {}
        exchanged = 0
        # the MoE models' rows: held to each data block's run alone
        held = m["blocks"] if name in MOE and BLOCKS[mesh] > 1 else m
        for res in ranks:
            r = res[name]
            assert r["resident_bytes"] == r["reckoned_bytes"], name
            lo, hi = r["rows"]
            for step, tok in enumerate(r["tokens"]):
                np.testing.assert_array_equal(
                    tok, np.asarray(held["ref"][step])[lo:hi],
                    err_msg=f"{name} step {step}")
            for step, lg in enumerate(r["logits"]):
                want = held["split_logits" if name in SPLIT_HELD else
                            "logits"][step][lo:hi]
                rel = np.abs(lg - want).max() / np.abs(want).max()
                assert rel <= BARS.get(name, LOGITS_REL), (name, step, rel)
            rows[(lo, hi)] = True
            if name == "granite_flash":
                assert r["flash_calls"] == STEPS * 2  # two layers a step
            else:
                assert r["flash_calls"] == 0
            # the bytes each step moved, as reckoned for this rank, and the
            # last decode's collectives by kind
            assert r["comm"] == r["reckoned_comm"], name
            assert r["by_kind"] == {
                k: v for k, v in serve_comm_by_kind(
                    r["reckoned_comm"][-1]).items() if v}, name
            exchanged += r["comm"][0]["model_cache_exchange_bytes"]
            assert r["slab_leaves"] > 0 and r["slab_gathered"] == 0, name
            gathered = sum(c["param_gather_bytes"] for c in r["comm"])
            assert (gathered > 0) == name.endswith("_whole"), name
        assert min(lo for lo, _ in rows) == 0
        assert max(hi for _, hi in rows) == BATCH
        # the prefill's new keys and values moved to the ranks holding
        # their positions: attention that splits over model (MLA writes
        # its own slab's latents; an SSM has no positions)
        assert (exchanged > 0) == (name in EXCHANGED), name


FAKE = """
import dataclasses, json, torch
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.launch.dryrun import measure
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.steps import build_step
from repro_torch.parallel.tensor import (
    data_shards, serve_bytes, serve_pods, serve_rows)
mesh = make_fake_mesh(SHAPE, AXES)
out = {}
for arch in ARCHS:
    for strategy in STRATEGIES:
        cfg = dataclasses.replace(get_smoke_config(arch), model_shards=4,
                                  decode_strategy=strategy)
        for spec in (ShapeSpec("p", "prefill", 64, ROWS),
                     ShapeSpec("d", "decode", 64, ROWS)):
            built = build_step(arch, spec, mesh, cfg=cfg)
            stats, _ = measure(built, mesh)
            blocks = serve_rows(mesh, ROWS)[1]
            rk = serve_bytes(cfg, built.meta["statics"], 4, ROWS // blocks,
                             spec.seq_len, spec.kind, spec.seq_len,
                             torch.bfloat16, spec.seq_len - 1, 0, blocks,
                             built.meta["placements"]["params"],
                             serve_pods(mesh, ROWS),
                             built.meta["placements"]["cache"],
                             dp=data_shards(mesh)[1])
            out[f"{arch}:{strategy}:{spec.kind}"] = {
                "op_stats": {k: v for k, v in
                             stats.collective_bytes_by_kind.items() if v},
                "by_dim": {k: v for k, v in
                           stats.collective_bytes_by_dim.items() if v},
                "reckoned": rk, "comm": dict(built.fn.comm),
                "routes": built.meta["routes"], "flops": stats.flops}
print(json.dumps(out))
"""


def _fake(archs, strategies, shape, axes, rows: int = 8) -> dict:
    from test_torch_dryrun import _python

    return _python(FAKE.replace("ROWS", repr(rows)).replace(
        "ARCHS", repr(archs)).replace(
        "STRATEGIES", repr(strategies)).replace("SHAPE", repr(shape))
        .replace("AXES", repr(axes)))


FAKE_ARCHS = ["granite_3_2b", "h2o_danube_1_8b", "phi3_medium_14b",
              "whisper_small", "deepseek_v2_236b", "jamba_1_5_large_398b",
              "paligemma_3b"]


@pytest.fixture(scope="module")
def fake_2x4():
    """``FAKE``'s records over a fake 2 x 4 ``(data, model)`` mesh."""
    return _fake(FAKE_ARCHS, ("gather", "flash"), (2, 4), ("data", "model"))


def test_serve_bytes_equal_op_stats_on_a_fake_mesh(fake_2x4):
    """``parallel.tensor.serve_bytes`` against ``launch.op_stats`` on rank 0
    of a fake 2 x 4 ``(data, model)`` mesh (``launch.steps.build_step``'s
    placed steps over fake tensors, nothing spawned): a prefill of 64
    positions (split along the sequence) and a decode at the cache's last
    position, on the gather and the flash decode routes, for dense,
    windowed, re-laid-out, encoder-decoder, MLA + MoE, SSM + MoE and
    prefix models; the step's own ``step.comm`` too."""
    from repro_torch.parallel.tensor import serve_comm_by_kind

    res = fake_2x4
    assert len(res) == len(FAKE_ARCHS) * 4
    for key, rec in res.items():
        want = {k: v for k, v in serve_comm_by_kind(rec["reckoned"]).items()
                if v}
        assert rec["op_stats"] == want and want, key
        assert rec["comm"] == rec["reckoned"], key
        # nothing gathered over data but MoE's counts, no param leaf
        assert rec["reckoned"]["param_gather_bytes"] == 0, key
        strategy, kind = key.split(":")[1:]
        assert rec["routes"].startswith("plain, on the model slabs"), key
        if kind == "decode":
            assert rec["routes"].endswith(strategy), key
    # the flash route gathers the queries and combines partial softmaxes,
    # never the key heads' positions
    for arch in ("granite_3_2b", "phi3_medium_14b", "paligemma_3b"):
        flash, gather = (res[f"{arch}:{s}:decode"]["reckoned"]
                         for s in ("flash", "gather"))
        assert flash["model_cache_exchange_bytes"] < gather[
            "model_cache_exchange_bytes"]
        assert flash["model_gather_bytes"] > gather["model_gather_bytes"]


def _split_logits(cfg, params, tokens) -> list:
    """The port's unsharded decode logits (prefill of ``tokens``, then
    ``STEPS`` greedy steps) with every row product that the placed steps
    split over 2 model ranks (``wo``, ``down``, the SSM's ``out_proj`` and
    its gated norm's sum of squares) summed as two float32 halves, first
    half first, as the placed steps' all-reduce adds the ranks' parts."""
    from repro_torch.models import attention, layers, ssm
    from repro_torch.runtime.serve import (
        ServeConfig,
        decode_logits,
        make_prefill_step,
    )

    split = {cfg.n_heads * cfg.d_head, cfg.d_ff}
    if cfg.ssm is not None:
        split.add(cfg.ssm.d_inner)
    if cfg.moe is not None:
        split.add(cfg.moe.d_ff_expert)
    real_linear = layers.linear

    def halves(a, b):
        k = a.shape[-1] // 2
        return a[..., :k].float() @ b[:k].float() + \
            a[..., k:].float() @ b[k:].float()

    def linear(p, x):
        if p["w"].shape[0] not in split:
            return real_linear(p, x)
        y = halves(x, p["w"])
        return (y + p["b"].float() if "b" in p else y).to(x.dtype)

    def rmsnorm(p, x, eps=1e-6):
        xf = x.float()
        ss = halves(xf * xf, torch.ones(xf.shape[-1], 1))
        y = xf * torch.rsqrt(ss / xf.shape[-1] + eps)
        return (y * p["scale"].float()).to(x.dtype)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (attention, layers, ssm):
            mp.setattr(mod, "linear", linear)
        mp.setattr(ssm, "rmsnorm", rmsnorm)
        statics = ttr.init_statics(cfg, "cpu")
        tp = lm_params_from_numpy(params, "cpu")
        cache = ttr.init_cache(statics, tokens.shape[0], MAX_SEQ,
                               dtype=torch.float32)
        total = tokens.shape[1] + cfg.prefix_len
        with torch.no_grad():
            tok, cache = make_prefill_step(cfg, statics, ServeConfig(
                max_seq=MAX_SEQ, cache_dtype="float32"))(
                tp, cache, torch.as_tensor(tokens, dtype=torch.long))
            out = []
            for i in range(STEPS):
                lg, cache = decode_logits(statics, tp, cache, tok,
                                          torch.tensor(total + i))
                tok = lg.argmax(dim=-1)
                out.append(lg.numpy())
    return out


def test_serve_bytes_over_pods_equal_op_stats_on_a_fake_mesh(fake_2x4):
    """The same on rank 0 of a fake 2 x 2 x 4 ``(pod, data, model)`` mesh,
    whose pods split each data block's rows (``parallel.tensor.
    serve_rows``): what each layer wrote of its cache slab (and the
    encoder's output) all-gathered over ``pod`` is reckoned, and the
    rank computes half the rows, and so about half the FLOPs of the same
    step over 2 x 4 (MoE's experts too: their buffers are each rank's
    block's capacity)."""
    from repro_torch.parallel.tensor import serve_comm_by_kind

    archs = ["granite_3_2b", "whisper_small", "deepseek_v2_236b",
             "jamba_1_5_large_398b"]
    pods = _fake(archs, ("gather",), (2, 2, 4), ("pod", "data", "model"))
    one = fake_2x4
    assert len(pods) == len(archs) * 2
    for key, rec in pods.items():
        want = {k: v for k, v in serve_comm_by_kind(rec["reckoned"]).items()
                if v}
        assert rec["op_stats"] == want and want, key
        assert rec["comm"] == rec["reckoned"], key
        # a prefill writes rank 0's positions (the decode, at the last
        # position, another model rank's; an SSM's state every step)
        shared = rec["reckoned"]["pod_gather_bytes"]
        assert shared <= rec["by_dim"].get("all-gather/pod", 0), key
        assert shared > 0 or key.endswith("decode"), key
        assert one[key]["reckoned"]["pod_gather_bytes"] == 0, key
        # the rank computes half the rows, MoE's experts half the
        # capacity (each rank's rows counted alone)
        assert rec["flops"] < 0.6 * one[key]["flops"], key


def test_serve_bytes_where_moe_counts_the_whole_batch():
    """2 rows over a fake 2 x 2 x 4 ``(pod, data, model)`` mesh: the pods
    do not divide each data block's one row, so the rows split over
    ``data`` only and MoE counts capacity over the whole batch, as the
    reference falls back to ``_moe_local`` where the batch does not
    divide over pod x data.  Each MoE layer all-gathers its per-expert
    counts over ``data``: ``serve_bytes`` reckons them, and ``step.comm``
    and ``launch.op_stats`` count them."""
    from repro_torch.parallel.tensor import serve_comm_by_kind

    archs = ["deepseek_v2_236b", "jamba_1_5_large_398b"]
    res = _fake(archs, ("gather",), (2, 2, 4), ("pod", "data", "model"),
                rows=2)
    assert len(res) == len(archs) * 2
    for key, rec in res.items():
        want = {k: v for k, v in serve_comm_by_kind(rec["reckoned"]).items()
                if v}
        assert rec["op_stats"] == want, key
        assert rec["comm"] == rec["reckoned"], key
        assert rec["reckoned"]["data_gather_bytes"] > 0, key


@pytest.mark.parametrize("name", SPLIT)
def test_split_row_sums_move_the_unsharded_logits(served, name):
    """Why ``SPLIT``'s models are not held to the plain unsharded run at
    ``LOGITS_REL``: the port's unsharded run with the placed steps'
    two-half row sums (``_split_logits``) moves their decode logits above
    ``LOGITS_REL`` of the unsplit run (within ``SPLIT_GAP``), for
    float32's sake alone."""
    m = served[name]
    rel = [np.abs(split - want).max() / np.abs(want).max()
           for split, want in zip(m["split_logits"], m["logits"])]
    assert LOGITS_REL < max(rel) <= SPLIT_GAP, rel
