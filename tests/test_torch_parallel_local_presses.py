"""The shard-local presses of ROADMAP Queue A items 18.1-18.11 under a
tensor-parallel mesh: CAP, CUR, CriticalKV, KeyRerotation,
PerLayerCompression, ThinK, Chunk, Composed, Merging, Block and Finch, each
on a gloo world of 2 ranks ("model" 2 on the tiny config with GQA 8/4, two
kv heads a rank) through ``Runner.prefill`` and decode steps (float32 and
int8 KV, float32 and int4 weights) and ``Runner.prefill_chunked``; and the
head-indexed presses of items 18.13, 18.14, 18.16 and 18.17 (Random,
QFilter, ExpectedAttentionStats, DuoAttention with its split-cache decode),
whose ranks read their slice of a global-head artifact or draw; and the
cross-head scorers of items 18.20-18.24 (TOVA, CriticalAdaKV, ChunkKV,
LUKV, SimLayerKV, and DecodingPress(TOVA) and ChunkKV(TOVA) over them),
whose ranks gather what they reduce across heads; and the normalized
scorers and CAM of items 18.25-18.28 (Compactor, LeverageScore,
NonCausalAttn, CAM), whose ranks gather their raw scores before the z-norm
(and CAM's before its mean over kv heads) and draw at every kv head.

Every sharded run is held against the JAX package's single-device run on
the same numpy inputs and against the port's single-process run, to
tests/test_torch_parallel.py's limits: logits (and each decode step's)
within LOGIT_TOL, equal lengths and offsets, the kept K/V within KV_RTOL of
their scale as sets (in place under a keep-mask), equal keep bits. A key
that is requantized (rerotated, or with ThinK's channels zeroed) over int8
KV is held within one code of its scale against JAX (its quantizer rounds
x * (1 / scale), eager code x / scale), and within KV_RTOL against the
port's single process. A few runs are also held against
JAX's GSPMD run over a (data 1, model 2) mesh of its virtual devices. Where
the single-process port refuses a chunked route, the mesh raises the same
error. CUR, LeverageScore and Compactor draw the JAX package's sketches,
and CAM its uniforms (handed to the ranks as numpy, at every kv head); the
Compactor family's gathered scores are held against JAX's ``score`` on
the single process's layer inputs within the scorer tests' 1e-4.
RandomPress draws from a torch generator, so it is held against the port's
single process on the same seed only.

The ranks run ``tests/torch_parallel_cases.py`` (no JAX there), one world
for the file, started before the parent computes the references."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.models.llama import quantize_params_int4 as jquant4
from kvpress_tpu.parallel.mesh import data_sharding, make_mesh as jmake_mesh
from kvpress_tpu.parallel.mesh import shard_params as jshard_params
import kvpress_tpu_torch as kt
from kvpress_tpu.ops import duo_decode as jduo
from kvpress_tpu_torch.parallel import MESH_ITEMS, MESH_PRESSES, check_press, check_seq_press
from kvpress_tpu_torch.parallel.mesh import local_config, shard_layer
from kvpress_tpu_torch.parallel.presses import SEQ_ITEM, WRAPPERS
from test_torch_parallel import KV_RTOL, LOGIT_TOL, assert_same_prefill, numpy_tree
from torch_parallel_cases import duo_split, finish_world, prefill, start_world
from torch_decoding_cases import jax_uniforms
from torch_scorer_cases import SOLVE_TOL, jax_sketch
from torch_wrapper_cases import jax_ctx

torch.set_num_threads(2)

MESH = {"data": 1, "model": 2}
OVER = dict(num_heads=8, num_kv_heads=4, intermediate_size=256)
S, CHUNK, DECODE_STEPS = 48, 16, 4
SNAP = dict(window_size=8)


def _surrogate(m):
    """A seeded linear KVzap surrogate with four kv-head outputs (the JAX
    press indexes it by a traced layer: jnp arrays there)."""
    rng = np.random.default_rng(11)
    cfg = kt.tiny_config()
    s = {"w": rng.standard_normal((cfg.num_layers, cfg.hidden_size, OVER["num_kv_heads"]))
         .astype(np.float32) * 0.3,
         "b": rng.standard_normal((cfg.num_layers, OVER["num_kv_heads"])).astype(np.float32)
         * 0.05}
    return s if m is kt else {k: jnp.asarray(v) for k, v in s.items()}


# label: the press, made with module m's classes (items 18.1-18.11).
PRESSES = {
    "cap": lambda m: m.CapPress(0.5, n_future_positions=16),
    "cur": lambda m: m.CURPress(0.5, use_random_leverage=True),
    "critical_knorm": lambda m: m.CriticalKVPress(m.KnormPress(0.5)),
    "critical_snapkv": lambda m: m.CriticalKVPress(m.SnapKVPress(0.5, **SNAP)),
    "key_rerotation": lambda m: m.KeyRerotationPress(m.KnormPress(0.5)),
    "per_layer": lambda m: m.PerLayerCompressionPress(m.KnormPress(0.5),
                                                      compression_ratios=(0.25, 0.75)),
    "think": lambda m: m.ThinKPress(key_channel_compression_ratio=0.5, window_size=8),
    "chunk": lambda m: m.ChunkPress(m.KnormPress(0.5), chunk_length=16),
    "composed": lambda m: m.ComposedPress((m.SnapKVPress(0.5, **SNAP),
                                           m.ThinKPress(0.5, window_size=8))),
    "merging": lambda m: m.MergingPress(m.KnormPress(0.5)),
    "block_keydiff": lambda m: m.BlockPress(m.KeyDiffPress(0.5), block_size=16),
    # KVzap scores from the hidden states: each kv head's part of them comes
    # from its own candidates, over every rank's heads.
    "block_kvzap": lambda m: m.BlockPress(m.KVzapPress(0.5, surrogate=_surrogate(m)),
                                          block_size=16),
    "finch": lambda m: m.FinchPress(0.5, window_size=12),
}


def _head_artifacts(seed=13):
    """Seeded stand-ins for the artifacts indexed by global head (numpy, for
    both packages): (L, H_kv, D) Q-filters, the (L, Hq, D) / (L, Hq, D, D)
    query statistics, and Duo's (L, H_kv) head scores; and two Duo patterns
    that leave rank 1 of "model" 2 no retrieval head in layer 0 ("layer")
    and in every layer ("every")."""
    rng = np.random.default_rng(seed)
    cfg = kt.tiny_config(**OVER)
    L, Hq, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    a = f(L, Hq, D, D) * 0.3
    return dict(q_filters=f(L, Hkv, D),
                stats={"mu": f(L, Hq, D), "cov": np.einsum("lhij,lhkj->lhik", a, a)},
                duo=f(L, Hkv),
                # ratio 0.5 prunes the four lowest: (0, 2), (0, 3), (1, 0), (1, 2)
                duo_layer=np.array([[5, 6, 1, 2], [3, 7, 4, 8]], np.float32),
                # (0, 2), (0, 3), (1, 2), (1, 3)
                duo_every=np.array([[5, 6, 1, 2], [7, 8, 3, 4]], np.float32))


ART = _head_artifacts()
DUO = dict(sink_size=4, recent_size=8)      # S = 48: slots 4-39 of a streaming head cleared
# label: a press of items 18.13, 18.14, 18.16 and 18.17, made with module
# m's classes (RandomPress with the port's only: a fresh generator each).
HEAD_PRESSES = {
    "qfilter": lambda m: m.QFilterPress(0.5, q_filters=ART["q_filters"]),
    "expected_attention_stats": lambda m: m.ExpectedAttentionStatsPress(
        0.5, n_future_positions=16, stats=ART["stats"]),
    "duo": lambda m: m.DuoAttentionPress(0.5, head_scores=ART["duo"], **DUO),
    "random": lambda m: m.RandomPress(0.5, generator=torch.Generator().manual_seed(5)),
}
DUO_PATTERNS = ("layer", "every")
DUO_STEPS = 4


def _lukv_curve(seed=14):
    """A seeded (99, L, H_kv) LU-KV curve whose prune fractions differ
    between the ranks' heads: rank 0's two heads 0.1-0.4, rank 1's 0.6-0.9."""
    rng = np.random.default_rng(seed)
    L = kt.tiny_config().num_layers
    return np.concatenate([rng.uniform(0.1, 0.4, (99, L, 2)), rng.uniform(0.6, 0.9, (99, L, 2))],
                          axis=-1).astype(np.float32)


LUKV_CURVE = _lukv_curve()
# SimLayerKV's lazy scores on the 48-token context are 0.405 (layer 0) and
# 0.362 (layer 1): 0.38 makes layer 0 lazy alone.
LAZY = 0.38
# label: a press of items 18.20-18.24 (and two compositions over TOVA), made
# with module m's classes.
CROSS_PRESSES = {
    "tova": lambda m: m.TOVAPress(0.5),
    "critical_ada_knorm": lambda m: m.CriticalAdaKVPress(m.KnormPress(0.5)),
    "critical_ada_knorm_compact": lambda m: m.CriticalAdaKVPress(m.KnormPress(0.5),
                                                                 compact=True),
    # 48 slots: four chunks of 10 and a partial tail of 8.
    "chunkkv_knorm": lambda m: m.ChunkKVPress(m.KnormPress(0.5), chunk_length=10),
    "lukv_knorm": lambda m: m.LUKVPress(m.KnormPress(0.5), compression_ratio=0.5, sink=2,
                                        window=4, budget_curves=LUKV_CURVE),
    "simlayerkv": lambda m: m.SimLayerKVPress(lazy_threshold=LAZY, n_recent=16),
    # Compresses at decode steps 2 and 4: 50 and 42 slots to 40.
    "decoding_tova": lambda m: m.DecodingPress(m.TOVAPress(), compression_interval=2,
                                               target_size=40, hidden_states_buffer_size=8),
    "chunkkv_tova": lambda m: m.ChunkKVPress(m.TOVAPress(0.5), chunk_length=10),
}
# label: a press of items 18.25-18.28, made with module m's classes.
NORM_PRESSES = {
    "compactor": lambda m: m.CompactorPress(0.5),
    # A sketch narrower than the head (16): as at the default 48 on a model's
    # head_dim of 64 or 128, the scores then depend on the draw.
    "leverage": lambda m: m.LeverageScorePress(0.5, sketch_dimension=8),
    "noncausal": lambda m: m.NonCausalAttnPress(0.5),
    # Compresses at decode steps 2 and 4: 50 and 42 slots to 40.
    "cam_knorm": lambda m: m.CAMPress(base_press=m.KnormPress(), compression_interval=2,
                                      target_size=40, hidden_states_buffer_size=8,
                                      merge_budget=4),
}
ALL_PRESSES = {**PRESSES, **HEAD_PRESSES, **CROSS_PRESSES, **NORM_PRESSES}

# route: the rank job's options beyond the press.
ROUTES = {"oneshot": {}, "int8": dict(kv_bits=8), "int4_weights": {}, "chunked": dict(chunk=CHUNK)}
CASES = ([(p, "oneshot") for p in PRESSES]
         + [(p, "int8") for p in ("critical_knorm", "key_rerotation", "composed", "finch")]
         + [(p, "int4_weights") for p in ("critical_knorm", "critical_snapkv")]
         + [(p, "chunked") for p in PRESSES
            if p not in ("cap", "merging", "block_keydiff", "block_kvzap")])
HEAD_CASES = ([(p, r) for p in ("qfilter", "expected_attention_stats", "duo") for r in ROUTES
               if (p, r) != ("expected_attention_stats", "chunked")]
              + [("random", "oneshot"), ("random", "chunked")])
CROSS_CASES = ([("tova", r) for r in ROUTES]
               + [("critical_ada_knorm", "oneshot"), ("critical_ada_knorm_compact", "oneshot"),
                  ("critical_ada_knorm", "chunked"), ("chunkkv_knorm", "oneshot"),
                  ("chunkkv_knorm", "chunked"), ("lukv_knorm", "oneshot"),
                  ("simlayerkv", "oneshot"), ("simlayerkv", "chunked"),
                  ("decoding_tova", "oneshot"), ("chunkkv_tova", "oneshot")])
NORM_CASES = [("compactor", "oneshot"), ("compactor", "int8"), ("leverage", "oneshot"),
              ("noncausal", "oneshot"), ("cam_knorm", "oneshot"), ("cam_knorm", "int8")]
# Their scores are recorded at each layer and held against JAX's.
SCORED = ("compactor", "leverage", "noncausal")
# The single-process port refuses these chunked; the mesh must say the same.
REFUSED_CHUNKED = ("cap", "merging", "block_keydiff", "expected_attention_stats", "lukv_knorm",
                   "compactor", "leverage", "noncausal")
# Also held against JAX's GSPMD run over its (data 1, model 2) mesh.
GSPMD = (("critical_knorm", "int4_weights"), ("block_kvzap", "oneshot"),
         ("composed", "oneshot"), ("duo", "oneshot"), ("tova", "oneshot"))
# Keys requantized after the press: one code of their scale.
REQUANTIZED = ("key_rerotation", "think", "composed", "finch")


def _models():
    """The GQA 8/4 tiny model in both packages, wq and wk scaled up as
    tests/torch_scorer_cases.py's ``tiny_models`` does (peaked attention,
    heads that differ), and its int4 quantization."""
    cfg_j, cfg_t = kj.tiny_config(**OVER), kt.tiny_config(**OVER)
    params = kj.init_params(cfg_j, jax.random.PRNGKey(4), dtype=jnp.float32)
    layers = dict(params["layers"])
    layers["wq"], layers["wk"] = layers["wq"] * 6.0, layers["wk"] * 6.0
    params = dict(params, layers=layers)
    return cfg_j, cfg_t, params, jquant4(params)


def _sketches(cfg) -> dict:
    """The JAX package's CUR sketch of each layer (seed 0)."""
    return {l: jax_sketch(0, l, (cfg.head_dim, 20)) for l in range(cfg.num_layers)}


def _leverage_sketches(cfg, press, batches=(1,)) -> dict:
    """The JAX package's sketch of ``press`` (LeverageScore, or Compactor's
    leverage child) for each layer and batch size, over every kv head: JAX
    draws it at the whole (B, H_kv, D, k), so each shape draws other
    numbers."""
    return {(l, b): jax_sketch(press.seed, l, (b, cfg.num_kv_heads, cfg.head_dim,
                                               press.sketch_dimension))
            for l in range(cfg.num_layers) for b in batches}


def _cam_uniforms(cfg, press, B=1, steps=DECODE_STEPS) -> dict:
    """The JAX package's CAM uniforms of each (layer, rng_step) over every kv
    head, at (B, H_kv, k)."""
    shape = (B, cfg.num_kv_heads, press.compression_interval)
    return {(l, t): jax_uniforms(press.seed, l, t, shape)
            for l in range(cfg.num_layers) for t in range(1, steps + 1)}


def _job(cfg_t, params, p4, ids, label, route):
    job = dict(cfg=cfg_t, params=numpy_tree(p4 if route == "int4_weights" else params), ids=ids,
               press=ALL_PRESSES[label](kt), mesh=MESH, **ROUTES[route])
    if route != "chunked":
        job["decode_steps"] = DECODE_STEPS
    if label == "cur":
        job["sketches"] = _sketches(cfg_t)
    if label in ("compactor", "leverage"):
        job["leverage"] = _leverage_sketches(cfg_t, job["press"])
    if label in SCORED:
        job["scores"] = True
    if label == "cam_knorm":
        job["uniforms"] = _cam_uniforms(cfg_t, job["press"])
    return job


_STEPS = {}


def _jax_step(cfg_j):
    """One jitted greedy decode step of the JAX runner (no press compresses
    in decode here), shared by every case."""
    if cfg_j not in _STEPS:
        runner = kj.Runner.create(cfg_j, attn_impl="xla")
        _STEPS[cfg_j] = jax.jit(lambda p, tok, cache: runner.forward(
            p, tok, cache, logits_last_only=True)[:2])
    return _STEPS[cfg_j]


def jax_run(cfg_j, params, ids, press, chunk=None, kv_bits=None, decode_steps=0, mesh=None):
    """The JAX package's run of a case: the prefill (eager, or jitted over
    ``mesh`` with params and ids sharded as its tensor-parallel tests shard
    them), then ``decode_steps`` greedy tokens; K/V dequantized on a
    quantized cache."""
    runner = kj.Runner.create(cfg_j, attn_impl="xla")
    p, x = params, jnp.asarray(ids)
    kw = dict(press=press, dtype=jnp.float32, compute_logits=True)
    decoding = getattr(press, "compresses_decode", False)
    if kv_bits:
        kw.update(quantized=True, kv_bits=kv_bits)
    scope = contextlib.nullcontext()
    if mesh is not None:
        p, x, scope = jshard_params(params, mesh), jax.device_put(x, data_sharding(mesh)), mesh
    with scope:
        if chunk:
            logits, cache, state = runner.prefill_chunked(p, x, chunk_size=chunk, **kw)
        elif mesh is not None:
            logits, cache, state = jax.jit(lambda p, x, press: runner.prefill(p, x, **dict(
                kw, press=press)), static_argnames=("press",))(p, x, press)
        else:
            logits, cache, state = runner.prefill(p, x, **kw)
        steps = []
        if decode_steps:
            cache = kj.cache.resize(cache, ids.shape[1] + decode_steps)
            if decoding:
                # A decode-time press compresses in the steps: its state threaded.
                step = jax.jit(lambda p, tok, cache, state: runner.forward(
                    p, tok, cache, press=press, press_state=state, phase="decode",
                    logits_last_only=True))
            else:
                plain = _jax_step(cfg_j)
                step = lambda p, tok, cache, state: (*plain(p, tok, cache), state)
            for _ in range(decode_steps):
                tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
                logits, cache, state = step(p, tok, cache, state)
                steps.append(np.asarray(logits))
    out = dict(logits=np.asarray(logits), length=np.asarray(cache.length),
               offset=int(cache.offset),
               mask=None if cache.mask is None else np.asarray(cache.mask))
    for name in ("keys", "values"):
        x = getattr(cache, name)
        if cache.key_scales is not None:
            x = kj.cache.dequantize_kv(x, getattr(cache, name[:-1] + "_scales"), cache.bits,
                                       jnp.float32)
        out[name] = np.asarray(x, np.float32)
    if cache.key_scales is not None:
        out["key_scales"] = np.asarray(cache.key_scales)
    if steps:
        out["steps"] = np.stack(steps)
    return out


def _jax_case(m, label, route, mesh=None):
    cfg_j, params, p4, ids = m["cfg_j"], m["params"], m["p4"], m["ids"]
    opts = ROUTES[route]
    return jax_run(cfg_j, p4 if route == "int4_weights" else params, ids, ALL_PRESSES[label](kj),
                   chunk=opts.get("chunk"), kv_bits=opts.get("kv_bits"),
                   decode_steps=0 if route == "chunked" else DECODE_STEPS, mesh=mesh)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg_j, _, params, p4 = _models()
    cfg_t = kt.tiny_config(**OVER)
    ids = np.random.default_rng(12).permutation(np.arange(3, cfg_j.vocab_size))[:S][None]
    jobs = {f"{label}-{route}": ("prefill", _job(cfg_t, params, p4, ids, label, route))
            for label, route in CASES + HEAD_CASES + CROSS_CASES + NORM_CASES}
    for label in REFUSED_CHUNKED:
        jobs[f"{label}-refused"] = ("refused", dict(kind="prefill", mesh=MESH, job=_job(
            cfg_t, params, p4, ids, label, "chunked")))
    # The mutant: ranks that draw only their own heads' random scores.
    jobs["random-local-draw"] = ("prefill", dict(_job(cfg_t, params, p4, ids, "random",
                                                      "oneshot"), mutant="random_local_draw"))
    # The mutant: ranks that decide across their own heads only.
    jobs["tova-local-decision"] = ("prefill", dict(_job(cfg_t, params, p4, ids, "tova",
                                                        "oneshot"),
                                                   mutant="cross_head_local_decision"))
    jobs["compactor-local-decision"] = ("prefill", dict(
        _job(cfg_t, params, p4, ids, "compactor", "oneshot"), mutant="cross_head_local_decision"))
    # The mutant: ranks that draw the sketch at their own heads only.
    jobs["leverage-own-draw"] = ("prefill", dict(_job(cfg_t, params, p4, ids, "leverage",
                                                      "oneshot"), mutant="own_heads_draw"))
    for pattern in DUO_PATTERNS:
        jobs[f"duo_split-{pattern}"] = ("duo_split", dict(
            cfg=cfg_t, params=numpy_tree(params), ids=ids, mesh=MESH, steps=DUO_STEPS,
            room=DUO_STEPS, press=_duo(kt, pattern)))
    handle = start_world(2, jobs, tmp_path_factory.mktemp("local"))
    m = dict(cfg_j=cfg_j, params=params, p4=p4, ids=ids, jobs=jobs)
    # The references, computed while the ranks run.
    every = CASES + HEAD_CASES + CROSS_CASES + NORM_CASES
    m["jax"] = {k: _jax_case(m, *k) for k in every if k[0] != "random"}
    m["single"] = {k: prefill(dict(jobs["-".join(k)][1], mesh=None)) for k in every}
    m["jax_scores"] = {k: _jax_scores(cfg_j, params, k[0], m["single"][k]["score_args"])
                       for k in NORM_CASES if k[0] in SCORED}
    m["duo_jax"] = {p: _jax_duo_split(cfg_j, params, ids, p) for p in DUO_PATTERNS}
    m["duo_single"] = {p: duo_split(dict(jobs[f"duo_split-{p}"][1], mesh=None))
                       for p in DUO_PATTERNS}
    m["got"] = finish_world(handle)
    return m


def _jax_scores(cfg_j, params, label, score_args):
    """JAX's ``score`` of the press of ``label`` on each layer's inputs of the
    port's single process (``score_args``: (ctx, keys, values) a layer), as
    (L, B, H_kv, S); JAX draws its own sketch."""
    press = ALL_PRESSES[label](kj)
    return np.stack([np.asarray(press.score(jax_ctx(ctx, cfg_j, params), jnp.asarray(k.numpy()),
                                            jnp.asarray(v.numpy())))
                     for ctx, k, v in score_args])


def _duo(m, pattern):
    return m.DuoAttentionPress(0.5, head_scores=ART[f"duo_{pattern}"], **DUO)


def _jax_duo_split(cfg_j, params, ids, pattern):
    """JAX's split-cache decode on one device: the Duo prefill,
    ``build_duo_split``, then DUO_STEPS greedy ``duo_decode_step`` calls."""
    runner, press = kj.Runner.create(cfg_j), _duo(kj, pattern)
    logits, cache, _ = runner.prefill(params, jnp.asarray(ids), press=press, dtype=jnp.float32,
                                      compute_logits=True)
    ds = jduo.build_duo_split(cache, press.streaming_mask(), DUO["sink_size"],
                              DUO["recent_size"], room=DUO_STEPS)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks, steps = [], []
    for _ in range(DUO_STEPS):
        tok, step, ds = jduo.duo_decode_step(params, tok, ds, runner=runner)
        toks.append(np.asarray(tok))
        steps.append(np.asarray(step))
    return dict(prefill=np.asarray(logits[:, -1]), tokens=np.concatenate(toks, axis=1),
                steps=np.stack(steps), len_r=np.asarray(ds.len_r).tolist(),
                offset=int(ds.offset))


def _assert_same(got, want, label, route, rounding=True):
    """tests/test_torch_parallel.py's limits; with ``rounding`` (against
    JAX, whose quantizer rounds otherwise), requantized keys over int8 KV
    within one code of their scale."""
    np.testing.assert_array_equal(got["length"], want["length"])
    assert got["offset"] == want["offset"]
    if "steps" in want:
        np.testing.assert_allclose(got["steps"], want["steps"], **LOGIT_TOL)
    if rounding and route == "int8" and label in REQUANTIZED:
        np.testing.assert_allclose(got["logits"], want["logits"], **LOGIT_TOL)
        for l, n in enumerate(want["length"].tolist()):
            step = want["key_scales"][l, :, :, :n, 0].max()
            np.testing.assert_allclose(got["values"][l, :, :, :n], want["values"][l, :, :, :n],
                                       atol=KV_RTOL * np.abs(want["values"][l]).max())
            assert np.abs(got["keys"][l, :, :, :n] - want["keys"][l, :, :, :n]).max() <= \
                step * (1 + 1e-5), (label, l)
        return
    assert_same_prefill(got, want)


@pytest.mark.parametrize("label,route", CASES, ids=[f"{p}-{r}" for p, r in CASES])
def test_local_press_under_a_mesh_matches_jax(world, label, route):
    """model 2: logits, each decode step's logits, lengths, offsets, kept K/V
    and keep bits equal the JAX single-device run's and the port's
    single-process run's (and, for a few, JAX's GSPMD run's)."""
    got = world["got"][f"{label}-{route}"]
    _assert_same(got, world["jax"][(label, route)], label, route)
    # The ranks and the single process run the same eager quantizer.
    _assert_same(got, world["single"][(label, route)], label, route, rounding=False)
    if (label, route) in GSPMD:
        _assert_same(got, _jax_case(world, label, route, mesh=jmake_mesh(**MESH)), label,
                     route)
    if label == "think" and route == "oneshot":
        # Half of each kv head's 16 channels zeroed, on both ranks' heads.
        zero = (got["keys"][:, :, :, :S] == 0).all(axis=3).sum(-1)
        assert (zero == 8).all(), zero


@pytest.mark.parametrize("label", REFUSED_CHUNKED)
def test_a_chunked_refusal_is_the_single_process_one(world, label):
    """CAP and ExpectedAttentionStats (no pre-RoPE queries in the
    compression pass), Merging (its merge), Block (every position's hidden
    states), LUKV (one-shot only) and the Compactor family (a query a slot)
    are refused by chunked prefill under the mesh with the single-process
    port's error."""
    job = world["jobs"][f"{label}-refused"][1]["job"]
    with pytest.raises((ValueError, TypeError)) as single:
        prefill(dict(job, mesh=None))
    assert world["got"][f"{label}-refused"] == f"{single.typename}: {single.value}"


@pytest.mark.parametrize("weights", ["float32", "int4"])
def test_critical_value_norm_of_a_rank_is_its_heads_slice(weights):
    """CriticalKV's ||Wo_h v||_1 on a rank (the local config, the rank's rows
    of ``wo`` from ``shard_layer``, the int4 ones repacked) equals the
    single-device norm's slice of the rank's kv heads, at model 2 and 4; a
    rank that takes another rank's rows does not."""
    cfg_j, cfg_t, params, p4 = _models()
    model = kt.params_from_jax(numpy_tree(p4 if weights == "int4" else params), cfg_t,
                               device="cpu", dtype=torch.float32)
    layer = {n: p.data for n, p in model.layers[0].named_parameters(recurse=False)}
    H, D = cfg_t.num_kv_heads, cfg_t.head_dim
    values = torch.randn(2, H, 24, D, generator=torch.Generator().manual_seed(0))

    def norm(cfg, tensors, v):
        ctx = type("Ctx", (), dict(cfg=cfg, layer_params=tensors))()
        return kt.CriticalKVPress.vwl1norm(ctx, v)

    want = norm(cfg_t, layer, values)
    for size in (2, 4):
        n = H // size
        local = local_config(cfg_t, size)
        for r in range(size):
            mine = values[:, r * n:(r + 1) * n]
            got = norm(local, shard_layer(layer, r, size), mine)
            torch.testing.assert_close(got, want[:, r * n:(r + 1) * n], atol=1e-5, rtol=1e-5)
            other = norm(local, shard_layer(layer, (r + 1) % size, size), mine)
            assert not torch.allclose(other, got, atol=1e-3), (size, r)


def test_the_eleven_run_under_a_mesh_and_the_rest_keep_their_items():
    """Items 18.1-18.11 are in MESH_PRESSES (each with its wrapped presses
    passing ``check_press``) and out of MESH_ITEMS; the rest of class (b)
    (FastKVzip, RestoreKV) and class (c) keep their numbers; the seq-mesh
    gate still refuses them (item 19)."""
    eleven = ("CapPress", "CURPress", "CriticalKVPress", "KeyRerotationPress",
              "PerLayerCompressionPress", "ThinKPress", "ChunkPress", "ComposedPress",
              "MergingPress", "BlockPress", "FinchPress")
    assert set(eleven) <= set(MESH_PRESSES) and not set(eleven) & set(MESH_ITEMS)
    assert set(WRAPPERS) < set(eleven)
    for make in PRESSES.values():
        check_press(make(kt))
    assert (MESH_ITEMS["FastKVzipPress"], MESH_ITEMS["RestoreKVPress"],
            MESH_ITEMS["KVzipPress"], MESH_ITEMS["KVComposeCollector"]) == (
        "18.18", "18.19", "18.29", "18.32")
    assert len(MESH_ITEMS) == 2 + 4
    for make in PRESSES.values():
        with pytest.raises(NotImplementedError, match=f"item {SEQ_ITEM} "):
            check_seq_press(make(kt))


@pytest.mark.parametrize("inner", [
    lambda: kt.KVzipPress(0.5),
    lambda: kt.KVComposePress(compression_ratio=0.5),
    lambda: kt.FastKVzipPress(0.5),
    lambda: kt.PrefillDecodingPress(kt.KVzipPress(0.5), None),
], ids=["kvzip", "kvcompose", "fastkvzip", "prefill_decoding_kvzip"])
def test_composed_press_refuses_a_later_item_inside(inner):
    """ComposedPress looks into its stages (and their wrapped presses): a
    stage of class (b) or (c) raises NotImplementedError naming that
    press's item."""
    stage = inner()
    name = type(getattr(stage, "prefilling_press", None) if type(stage).__name__ in MESH_PRESSES
                else stage).__name__
    with pytest.raises(NotImplementedError, match=f"item {MESH_ITEMS[name]} "):
        check_press(kt.ComposedPress((kt.KnormPress(0.5), stage)))


@pytest.mark.parametrize("name", sorted(MESH_ITEMS))
def test_every_name_left_in_mesh_items_is_refused(name):
    """Every press of classes (b) and (c) is still refused under a mesh,
    naming its own item, alone and as a stage of ComposedPress."""
    import kvpress_tpu_torch.presses as presses

    press = object.__new__(getattr(presses, name))      # the class, not its arguments
    for p in (press, object.__new__(kt.ComposedPress)):
        if p is not press:
            object.__setattr__(p, "presses", (kt.KnormPress(0.5), press))
        with pytest.raises(NotImplementedError, match=f"item {MESH_ITEMS[name]} "):
            check_press(p)


# --------------------------------------------------------------------- #
# Items 18.13, 18.14, 18.16 and 18.17: the head-indexed presses


@pytest.mark.parametrize("label,route", HEAD_CASES, ids=[f"{p}-{r}" for p, r in HEAD_CASES])
def test_head_indexed_press_under_a_mesh_matches_jax(world, label, route):
    """model 2: QFilter, ExpectedAttentionStats and Duo equal the JAX
    single-device run (Duo also JAX's GSPMD run) and the port's single
    process; Random the port's single process on the same seed."""
    got = world["got"][f"{label}-{route}"]
    if label != "random":
        _assert_same(got, world["jax"][(label, route)], label, route)
    _assert_same(got, world["single"][(label, route)], label, route, rounding=False)
    if (label, route) in GSPMD:
        _assert_same(got, _jax_case(world, label, route, mesh=jmake_mesh(**MESH)), label,
                     route)
    if label == "duo" and route == "oneshot":
        # Four streaming heads over both layers: slots 4-39 cleared on each.
        cleared = ~got["mask"][:, 0, :, :S]
        assert cleared.sum() == 4 * (S - DUO["sink_size"] - DUO["recent_size"])


def test_random_ranks_drawing_their_local_shape_are_rejected(world):
    """The mutant: ranks that draw (B, H_kv local, S) from the generator (the
    same numbers for different heads) differ from the single process."""
    got = world["got"]["random-local-draw"]
    assert_same_prefill(world["got"]["random-oneshot"], world["single"][("random", "oneshot")])
    with pytest.raises(AssertionError):
        assert_same_prefill(got, world["single"][("random", "oneshot")])


@pytest.mark.parametrize("pattern", DUO_PATTERNS)
def test_duo_split_decode_on_the_sharded_runner_matches_jax(world, pattern):
    """Duo's split decode on each rank's heads (``build_duo_split(...,
    shard=)``, ``duo_decode_step`` on the sharded runner): JAX's
    single-device tokens and logits, and the port's single process. Rank 1
    holds no retrieval head in layer 0 ("layer") or in any layer ("every"):
    its retrieval buffer keeps both its lanes, padded where it holds none
    (the width is H_kv less the fewest streaming heads of a layer, taken
    with ``initial=0`` as the JAX package does: H_kv)."""
    got, want = world["got"][f"duo_split-{pattern}"], world["duo_jax"][pattern]
    single = world["duo_single"][pattern]
    for ref in (want, single):
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        np.testing.assert_allclose(got["prefill"], ref["prefill"], **LOGIT_TOL)
        np.testing.assert_allclose(got["steps"], ref["steps"], **LOGIT_TOL)
        assert got["len_r"] == ref["len_r"] and got["offset"] == ref["offset"]
    # (retrieval, streaming) buffer heads on ranks 0 and 1, and on one device.
    assert got["heads"] == [(2, 1), (2, 2)] and single["heads"] == [(4, 2)]


def _slice_ctx(layer, rank, size, S):
    """The fields of a LayerCtx the four presses read, for rank ``rank`` of
    a model ``size`` mesh (one device: ``size`` None)."""
    cfg = kt.tiny_config(**OVER)
    return types.SimpleNamespace(
        layer_idx=layer, seq_len=S, attention_scaling=1.0,
        shard=None if size is None else types.SimpleNamespace(rank=rank, size=size),
        cfg=cfg if size is None else local_config(cfg, size),
        inv_freq=kt.Runner.create(cfg, device="cpu").inv_freq)


@pytest.mark.parametrize("label", list(HEAD_PRESSES))
def test_a_ranks_artifact_slice_is_its_heads_part(label):
    """A rank's scores (QFilter; ExpectedAttentionStats' statistics and its
    scores past the sinks; Random's draw from a generator seeded alike) and
    Duo's keep-mask equal the single device's at the rank's heads, at model
    2 and 4; the mutant, a rank that reads the other rank's slice, does
    not."""
    cfg = kt.tiny_config(**OVER)
    H, G, S = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, 24
    g = torch.Generator().manual_seed(1)
    keys, values = (torch.randn(1, H, S, cfg.head_dim, generator=g) for _ in range(2))

    def run(layer, heads, rank=0, size=None):
        """(tensor, its head axis' group size: 1 kv heads, G query heads)."""
        # Duo's "every" pattern: the two ranks' halves differ in each layer.
        press = _duo(kt, "every") if label == "duo" else HEAD_PRESSES[label](kt)
        ctx = _slice_ctx(layer, rank, size, S)
        k, v = keys[:, heads], values[:, heads]
        if label == "duo":
            return [(press._keep(ctx, S, k), 1)]
        if label == "expected_attention_stats":
            mu, cov = press.query_statistics(ctx)
            return [(mu, G), (cov, G), (press.score(ctx, k, v)[..., press.n_sink:], 1)]
        return [(press.score(ctx, k, v), 1)]

    def same(got, want, heads):
        return all(torch.equal(a, b[:, heads.start * n:heads.stop * n])
                   for (a, _), (b, n) in zip(got, want))

    rejected = []
    for layer in range(cfg.num_layers):
        want = run(layer, slice(None))
        for size in (2, 4):
            n = H // size
            for r in range(size):
                heads = slice(r * n, (r + 1) * n)
                assert same(run(layer, heads, r, size), want, heads), (layer, size, r)
                if size == 2:
                    rejected.append(not same(run(layer, heads, 1 - r, size), want, heads))
    assert all(rejected), rejected


# --------------------------------------------------------------------- #
# Items 18.20-18.24: the cross-head scorers


@pytest.mark.parametrize("label,route", CROSS_CASES, ids=[f"{p}-{r}" for p, r in CROSS_CASES])
def test_cross_head_press_under_a_mesh_matches_jax(world, label, route):
    """model 2: TOVA, CriticalAdaKV (mask form and compact), ChunkKV, LUKV,
    SimLayerKV, DecodingPress(TOVA) and ChunkKV(TOVA) equal the JAX
    single-device run (TOVA also JAX's GSPMD run) and the port's single
    process, though each decides over heads that two ranks hold."""
    got = world["got"][f"{label}-{route}"]
    _assert_same(got, world["jax"][(label, route)], label, route)
    _assert_same(got, world["single"][(label, route)], label, route, rounding=False)
    if (label, route) in GSPMD:
        _assert_same(got, _jax_case(world, label, route, mesh=jmake_mesh(**MESH)), label,
                     route)
    if label == "simlayerkv":
        # Layer 0 lazy, cut to sink + recent; layer 1 whole.
        assert got["length"][0] < got["length"][1], got["length"]
        return
    if got["mask"] is None:
        return
    kept = got["mask"][:, 0, :, :S].sum(-1)                                # (L, H_kv)
    if label == "lukv_knorm":
        # Rank 0's heads prune less than rank 1's.
        assert kept[:, :2].min() > kept[:, 2:].max(), kept
    if label.startswith("critical_ada"):
        # The budgets of a flat top across heads: the heads keep unequal counts.
        assert (kept.min(-1) < kept.max(-1)).all(), kept


def test_cross_head_local_decision_mutant_is_rejected(world):
    """The mutant: ranks whose ``all_heads`` gives their own heads in place
    of every rank's (TOVA's mean over the rank's four query heads) keep
    another set than JAX."""
    want = world["jax"][("tova", "oneshot")]
    assert_same_prefill(world["got"]["tova-oneshot"], want)
    with pytest.raises(AssertionError):
        assert_same_prefill(world["got"]["tova-local-decision"], want)


def test_the_cross_head_five_run_under_a_mesh_and_not_over_seq():
    """Items 18.20-18.24 pass ``check_press``, also inside AdaKV, ChunkKV
    and DecodingPress; MESH_ITEMS holds the 6 names of items 18.18, 18.19
    and 18.29-18.32; the seq-mesh gate still refuses the five (item 19)."""
    five = ("TOVAPress", "CriticalAdaKVPress", "ChunkKVPress", "LUKVPress", "SimLayerKVPress")
    assert set(five) <= set(MESH_PRESSES) and not set(five) & set(MESH_ITEMS)
    assert sorted(MESH_ITEMS.values()) == ["18.18", "18.19"] + [f"18.{i}" for i in
                                                                range(29, 33)]
    for press in ([make(kt) for make in CROSS_PRESSES.values()]
                  + [kt.AdaKVPress(kt.TOVAPress(0.5)), kt.ChunkKVPress(kt.TOVAPress(0.5))]):
        check_press(press)
    for make in CROSS_PRESSES.values():
        with pytest.raises(NotImplementedError, match=f"item {SEQ_ITEM} "):
            check_seq_press(make(kt), decode=isinstance(make(kt), kt.DecodingPress))


# --------------------------------------------------------------------- #
# Items 18.25-18.28: the normalized scorers and CAM


@pytest.mark.parametrize("label,route", NORM_CASES, ids=[f"{p}-{r}" for p, r in NORM_CASES])
def test_normalized_press_under_a_mesh_matches_jax(world, label, route):
    """model 2: Compactor (float32 and int8 KV), LeverageScore,
    NonCausalAttn and CAM(Knorm) over four decode steps (float32 and int8
    KV, JAX's uniforms) equal the JAX single-device run and the port's
    single process, though each normalizes or averages over heads that two
    ranks hold. The Compactor family's gathered scores of every layer are
    within KV_RTOL of their scale of the single process's and within the
    scorer tests' 1e-4 of JAX's ``score`` on the same layer inputs."""
    got = world["got"][f"{label}-{route}"]
    _assert_same(got, world["jax"][(label, route)], label, route)
    single = world["single"][(label, route)]
    _assert_same(got, single, label, route, rounding=False)
    if label in SCORED:
        assert got["scores"].shape == single["scores"].shape == (
            kt.tiny_config().num_layers, 1, OVER["num_kv_heads"], S)
        np.testing.assert_allclose(got["scores"], single["scores"], rtol=0,
                                   atol=KV_RTOL * np.abs(single["scores"]).max())
        np.testing.assert_allclose(got["scores"], world["jax_scores"][(label, route)],
                                   **SOLVE_TOL)
        # z-normed over every head: mean 0 and std 1 over the gathered scores
        # (Compactor blends two of them; its sinks hold the max).
        if label != "compactor":
            z = got["scores"].reshape(got["scores"].shape[0], -1)
            np.testing.assert_allclose(z.mean(-1), 0.0, atol=1e-5)
            np.testing.assert_allclose(z.std(-1, ddof=1), 1.0, atol=1e-5)
    if label == "cam_knorm":
        # Compressed at steps 2 and 4: the target after the last.
        assert (got["length"] == 40).all() and got["offset"] == S + DECODE_STEPS, got["length"]


def test_leverage_ranks_drawing_at_their_own_heads_are_rejected(world):
    """The mutant: ranks that draw LeverageScore's sketch at their own head
    count (each rank the first heads' sketch) keep another set than JAX."""
    want = world["jax"][("leverage", "oneshot")]
    assert_same_prefill(world["got"]["leverage-oneshot"], want)
    with pytest.raises(AssertionError):
        assert_same_prefill(world["got"]["leverage-own-draw"], want)


def test_compactor_local_decision_mutant_is_rejected(world):
    """The mutant ``cross_head_local_decision`` on Compactor: ranks that
    z-norm their own heads' scores and take their own max for the sinks
    keep another set than JAX."""
    want = world["jax"][("compactor", "oneshot")]
    assert_same_prefill(world["got"]["compactor-oneshot"], want)
    with pytest.raises(AssertionError):
        assert_same_prefill(world["got"]["compactor-local-decision"], want)


def test_the_normalized_four_run_under_a_mesh_and_not_over_seq():
    """Items 18.25-18.28 pass ``check_press``, Compactor also inside
    CriticalKV and as a stage of ComposedPress; MESH_ITEMS holds the 6
    names of items 18.18, 18.19 and 18.29-18.32; the seq-mesh gate still
    refuses the four (item 19)."""
    four = ("CompactorPress", "LeverageScorePress", "NonCausalAttnPress", "CAMPress")
    assert set(four) <= set(MESH_PRESSES) and not set(four) & set(MESH_ITEMS)
    assert sorted(MESH_ITEMS.values()) == ["18.18", "18.19"] + [f"18.{i}" for i in
                                                                range(29, 33)]
    for press in ([make(kt) for make in NORM_PRESSES.values()]
                  + [kt.CriticalKVPress(kt.CompactorPress(0.5)),
                     kt.ComposedPress((kt.KnormPress(0.5), kt.NonCausalAttnPress(0.5)))]):
        check_press(press)
    for make in NORM_PRESSES.values():
        with pytest.raises(NotImplementedError, match=f"item {SEQ_ITEM} "):
            check_seq_press(make(kt), decode=isinstance(make(kt), kt.DecodingPress))
