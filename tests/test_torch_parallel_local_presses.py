"""The shard-local presses of ROADMAP Queue A items 18.1-18.11 under a
tensor-parallel mesh: CAP, CUR, CriticalKV, KeyRerotation,
PerLayerCompression, ThinK, Chunk, Composed, Merging, Block and Finch, each
on a gloo world of 2 ranks ("model" 2 on the tiny config with GQA 8/4, two
kv heads a rank) through ``Runner.prefill`` and decode steps (float32 and
int8 KV, float32 and int4 weights) and ``Runner.prefill_chunked``.

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
error. CUR draws the JAX package's sketch (handed to the ranks as numpy).

The ranks run ``tests/torch_parallel_cases.py`` (no JAX there), one world
for the file, started before the parent computes the references."""

import contextlib

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
from kvpress_tpu_torch.parallel import MESH_ITEMS, MESH_PRESSES, check_press, check_seq_press
from kvpress_tpu_torch.parallel.mesh import local_config, shard_layer
from kvpress_tpu_torch.parallel.presses import SEQ_ITEM, WRAPPERS
from test_torch_parallel import KV_RTOL, LOGIT_TOL, assert_same_prefill, numpy_tree
from torch_parallel_cases import finish_world, prefill, start_world
from torch_scorer_cases import jax_sketch

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
# route: the rank job's options beyond the press.
ROUTES = {"oneshot": {}, "int8": dict(kv_bits=8), "int4_weights": {}, "chunked": dict(chunk=CHUNK)}
CASES = ([(p, "oneshot") for p in PRESSES]
         + [(p, "int8") for p in ("critical_knorm", "key_rerotation", "composed", "finch")]
         + [(p, "int4_weights") for p in ("critical_knorm", "critical_snapkv")]
         + [(p, "chunked") for p in PRESSES
            if p not in ("cap", "merging", "block_keydiff", "block_kvzap")])
# The single-process port refuses these chunked; the mesh must say the same.
REFUSED_CHUNKED = ("cap", "merging", "block_keydiff")
# Also held against JAX's GSPMD run over its (data 1, model 2) mesh.
GSPMD = (("critical_knorm", "int4_weights"), ("block_kvzap", "oneshot"),
         ("composed", "oneshot"))
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


def _job(cfg_t, params, p4, ids, label, route):
    job = dict(cfg=cfg_t, params=numpy_tree(p4 if route == "int4_weights" else params), ids=ids,
               press=PRESSES[label](kt), mesh=MESH, **ROUTES[route])
    if route != "chunked":
        job["decode_steps"] = DECODE_STEPS
    if label == "cur":
        job["sketches"] = _sketches(cfg_t)
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
    if kv_bits:
        kw.update(quantized=True, kv_bits=kv_bits)
    scope = contextlib.nullcontext()
    if mesh is not None:
        p, x, scope = jshard_params(params, mesh), jax.device_put(x, data_sharding(mesh)), mesh
    with scope:
        if chunk:
            logits, cache, _ = runner.prefill_chunked(p, x, chunk_size=chunk, **kw)
        elif mesh is not None:
            logits, cache, _ = jax.jit(lambda p, x, press: runner.prefill(p, x, **dict(
                kw, press=press)), static_argnames=("press",))(p, x, press)
        else:
            logits, cache, _ = runner.prefill(p, x, **kw)
        steps = []
        if decode_steps:
            cache = kj.cache.resize(cache, ids.shape[1] + decode_steps)
            step = _jax_step(cfg_j)
            for _ in range(decode_steps):
                tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
                logits, cache = step(p, tok, cache)
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
    return jax_run(cfg_j, p4 if route == "int4_weights" else params, ids, PRESSES[label](kj),
                   chunk=opts.get("chunk"), kv_bits=opts.get("kv_bits"),
                   decode_steps=0 if route == "chunked" else DECODE_STEPS, mesh=mesh)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg_j, _, params, p4 = _models()
    cfg_t = kt.tiny_config(**OVER)
    ids = np.random.default_rng(12).permutation(np.arange(3, cfg_j.vocab_size))[:S][None]
    jobs = {f"{label}-{route}": ("prefill", _job(cfg_t, params, p4, ids, label, route))
            for label, route in CASES}
    for label in REFUSED_CHUNKED:
        jobs[f"{label}-refused"] = ("refused", dict(kind="prefill", mesh=MESH, job=_job(
            cfg_t, params, p4, ids, label, "chunked")))
    handle = start_world(2, jobs, tmp_path_factory.mktemp("local"))
    m = dict(cfg_j=cfg_j, params=params, p4=p4, ids=ids, jobs=jobs)
    # The references, computed while the ranks run.
    m["jax"] = {k: _jax_case(m, *k) for k in CASES}
    m["single"] = {k: prefill(dict(jobs["-".join(k)][1], mesh=None)) for k in CASES}
    m["got"] = finish_world(handle)
    return m


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
    """CAP (no pre-RoPE queries in the compression pass), Merging (its
    merge) and Block (every position's hidden states) are refused by chunked
    prefill under the mesh with the single-process port's error."""
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
    passing ``check_press``) and out of MESH_ITEMS; classes (b) and (c) keep
    their numbers; the seq-mesh gate still refuses them (item 19)."""
    eleven = ("CapPress", "CURPress", "CriticalKVPress", "KeyRerotationPress",
              "PerLayerCompressionPress", "ThinKPress", "ChunkPress", "ComposedPress",
              "MergingPress", "BlockPress", "FinchPress")
    assert set(eleven) <= set(MESH_PRESSES) and not set(eleven) & set(MESH_ITEMS)
    assert set(WRAPPERS) < set(eleven)
    for make in PRESSES.values():
        check_press(make(kt))
    assert (MESH_ITEMS["RandomPress"], MESH_ITEMS["RestoreKVPress"], MESH_ITEMS["TOVAPress"],
            MESH_ITEMS["KVComposeCollector"]) == ("18.13", "18.19", "18.20", "18.32")
    assert len(MESH_ITEMS) == 6 + 13
    for make in PRESSES.values():
        with pytest.raises(NotImplementedError, match=f"item {SEQ_ITEM} "):
            check_seq_press(make(kt))


@pytest.mark.parametrize("inner", [
    lambda: kt.TOVAPress(0.5),
    lambda: kt.QFilterPress(0.5, q_filters=np.zeros((2, 2, 16), np.float32)),
    lambda: kt.ChunkKVPress(kt.KnormPress(0.5)),
    lambda: kt.CriticalKVPress(kt.RandomPress(0.5, generator=torch.Generator())),
], ids=["tova", "qfilter", "chunkkv", "critical_random"])
def test_composed_press_refuses_a_later_item_inside(inner):
    """ComposedPress looks into its stages (and their wrapped presses): a
    stage of class (b) or (c) raises NotImplementedError naming that
    press's item."""
    stage = inner()
    name = type(getattr(stage, "press", None) if type(stage).__name__ in MESH_PRESSES
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
