"""KVzapPress and DMSPress (ROADMAP items 18.12 and 18.15) under a
tensor-parallel mesh: a gloo world of 2 ranks ("model" 2, two kv heads a
rank) against the JAX package's GSPMD run over a (data 1, model 2) mesh of
its virtual devices, and against the port's single-process run.

A rank scores its own kv heads (its columns of the surrogate's output
layer); DMS thresholds each head on its own: the prefill mask, one-shot and
chunked, ``compact=True`` (a layer as long as its longest head over both
ranks) and ``decoding=True`` (each head's ring through decode steps); and
the serving engine over the mesh with DMS(KVzap) compact. Held to
tests/test_torch_parallel.py's limits: logits within LOGIT_TOL, equal
lengths, kept K/V within KV_RTOL of their scale, equal keep-masks. The
ranks run ``tests/torch_parallel_cases.py`` (no JAX there)."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import serving as jserving
from kvpress_tpu.cache import compact_masked as j_compact
from kvpress_tpu.parallel.mesh import data_sharding, make_mesh as jmake_mesh
from kvpress_tpu.parallel.mesh import shard_params as jshard_params
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.parallel import MESH_ITEMS, MESH_PRESSES, check_press
from test_torch_parallel import LOGIT_TOL, assert_same_prefill, numpy_tree
from torch_parallel_cases import prefill, run_world, serve
from torch_serving_cases import Models, assert_same, make_requests, requests

torch.set_num_threads(2)

MESH = {"data": 1, "model": 2}
OVER = dict(num_heads=8, num_kv_heads=4, intermediate_size=256)
S = 48
DECODE_STEPS = 6
ENGINE = dict(n_slots=2, capacity=64, question_bucket=4, fetch_lag=2)


def _surrogates():
    """A seeded MLP (hidden 16) and linear surrogate with four kv-head
    outputs of about unit spread around 0 on the tiny model's hidden
    states."""
    rng = np.random.default_rng(11)
    L, E, H = kt.tiny_config().num_layers, kt.tiny_config().hidden_size, OVER["num_kv_heads"]
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    mlp = {"w1": f(L, E, 16) * 0.5, "b1": f(L, 16) * 0.1, "w2": f(L, 16, H) * 0.5,
           "b2": np.zeros((L, H), np.float32)}
    linear = {"w": f(L, E, H) * 0.3, "b": f(L, H) * 0.05}
    return {"mlp": mlp, "linear": linear}


SURROGATES = _surrogates()


def _press(m, name):
    """(press) of ``name`` made with module ``m``'s classes; the JAX press
    takes its surrogate as jnp arrays."""
    def kvzap(kind, ratio=0.5):
        s = SURROGATES[kind]
        return m.KVzapPress(ratio, surrogate=s if m is kt else
                            {k: jnp.asarray(v) for k, v in s.items()})
    return {
        "kvzap_mlp": lambda: kvzap("mlp"),
        "kvzap_linear": lambda: kvzap("linear"),
        "dms_mask": lambda: m.DMSPress(kvzap("mlp"), threshold=0.0, sliding_window_size=16),
        "dms_compact": lambda: m.DMSPress(kvzap("linear"), threshold=0.0,
                                          sliding_window_size=16, compact=True),
        "dms_chunked": lambda: m.DMSPress(kvzap("mlp"), threshold=0.0, sliding_window_size=16),
        "dms_decoding": lambda: m.DMSPress(kvzap("linear"), threshold=0.0,
                                           sliding_window_size=16, decoding=True),
    }[name]()


# label: the rank job's options beyond the press
JOBS = {"kvzap_mlp": {}, "kvzap_linear": {}, "dms_mask": {}, "dms_compact": dict(compact=True),
        "dms_chunked": dict(chunk=16), "dms_decoding": dict(decode_steps=DECODE_STEPS)}


def jax_run(cfg_j, params, ids, press, mesh=None, compact=False, chunk=None, decode_steps=0):
    """The JAX package's run of a job: prefill (jitted, or chunked), then
    ``compact_masked`` or decode steps through the press; over ``mesh``
    with the params and ids sharded as its tensor-parallel tests shard them
    (GSPMD), else on one device."""
    runner = kj.Runner.create(cfg_j, attn_impl="xla")
    p, x = params, jnp.asarray(ids)
    scope = contextlib.nullcontext()
    if mesh is not None:
        p, x, scope = jshard_params(params, mesh), jax.device_put(x, data_sharding(mesh)), mesh
    with scope:
        if chunk:
            logits, cache, state = runner.prefill_chunked(p, x, press=press, chunk_size=chunk,
                                                          dtype=jnp.float32,
                                                          compute_logits=True)
        else:
            logits, cache, state = jax.jit(
                lambda p, x, press: runner.prefill(p, x, press=press, dtype=jnp.float32,
                                                   compute_logits=True),
                static_argnames=("press",))(p, x, press)
        if compact:
            cache = j_compact(cache)
        steps = []
        if decode_steps:
            cache = kj.cache.resize(cache, ids.shape[1] + decode_steps)
            for _ in range(decode_steps):
                tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
                logits, cache, state = runner.forward(p, tok, cache, press=press,
                                                      press_state=state, phase="decode",
                                                      logits_last_only=True)
                steps.append(np.asarray(logits))
    out = dict(logits=np.asarray(logits), length=np.asarray(cache.length),
               keys=np.asarray(cache.keys), values=np.asarray(cache.values),
               mask=None if cache.mask is None else np.asarray(cache.mask))
    if steps:
        out["steps"] = np.stack(steps)
    return out


def _dms_cases(m):
    """{label: (requests, JAX press, port press)} of the engine over the mesh."""
    reqs = make_requests(m.cfg_t.vocab_size, [(40, 4), (48, 8), (36, 4)], n_new=5)
    return {"serve_dms_compact": (reqs, _press(kj, "dms_compact"), _press(kt, "dms_compact")),
            "serve_dms_mask": (reqs, _press(kj, "dms_mask"), _press(kt, "dms_mask"))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg_j, cfg_t = kj.tiny_config(**OVER), kt.tiny_config(**OVER)
    params = kj.init_params(cfg_j, jax.random.PRNGKey(4), dtype=jnp.float32)
    m = Models(cfg_j, cfg_t, params, kt.params_from_jax(numpy_tree(params), cfg_t,
                                                        device="cpu", dtype=torch.float32))
    ids = np.random.default_rng(12).permutation(cfg_j.vocab_size)[:S][None]
    tree = numpy_tree(params)
    jobs = {label: ("prefill", dict(cfg=cfg_t, params=tree, ids=ids, press=_press(kt, label),
                                    mesh=MESH, **opts))
            for label, opts in JOBS.items()}
    for label, (reqs, _, tp) in _dms_cases(m).items():
        jobs[label] = ("serve", dict(cfg=cfg_t, params=tree, requests=reqs, mesh=MESH,
                                     engine=dict(ENGINE, press=tp)))
    return dict(m=m, ids=ids, jobs=jobs, got=run_world(2, jobs, tmp_path_factory.mktemp("kz")))


def _assert_steps(got, want):
    np.testing.assert_allclose(got["steps"], want["steps"], **LOGIT_TOL)


@pytest.mark.parametrize("label", list(JOBS))
def test_kvzap_and_dms_under_a_mesh_match_jax_gspmd(world, label):
    """model 2: logits, lengths, kept K/V and keep-masks (and the decode
    steps' logits) equal the JAX run over its (data 1, model 2) mesh, the
    JAX single-device run and the port's single-process run."""
    m, ids = world["m"], world["ids"]
    got = world["got"][label]
    jp = _press(kj, label)
    opts = JOBS[label]
    want = jax_run(m.cfg_j, m.params_j, ids, jp, mesh=jmake_mesh(**MESH), **opts)
    for ref in (want, jax_run(m.cfg_j, m.params_j, ids, jp, **opts),
                prefill(dict(world["jobs"][label][1], mesh=None))):
        assert_same_prefill(got, ref)
        if "steps" in ref:
            _assert_steps(got, ref)
    if label.startswith("dms"):
        n = got["length"]
        valid = np.broadcast_to(np.arange(got["mask"].shape[-1]) < n[:, None, None, None],
                                got["mask"].shape)
        frac = (valid & ~got["mask"]).sum() / valid.sum()
        assert 0.1 < frac < 0.9, frac


def test_dms_compact_length_is_the_longest_head_over_both_ranks(world):
    """Compaction under the mesh: each layer's length is its longest head's
    kept count over every rank's heads, and each head's keep-mask is its
    prefix."""
    got = world["got"]["dms_compact"]
    counts = got["mask"][..., :got["mask"].shape[-1]].sum(-1)        # (L, B, H)
    np.testing.assert_array_equal(got["length"], counts.max(axis=(1, 2)))
    assert (counts.max(axis=(1, 2)) > counts.min(axis=(1, 2))).all()


def test_dms_decoding_clears_bits_in_each_head_ring(world):
    """Decode steps under the mesh push each head's scores through its own
    ring: bits below the prefill's window are cleared during the steps, as
    in the single-process run."""
    got = world["got"]["dms_decoding"]
    single = prefill(dict(world["jobs"]["dms_decoding"][1], mesh=None, decode_steps=0))
    assert (~got["mask"][..., :S]).sum() > (~single["mask"][..., :S]).sum()


@pytest.mark.parametrize("label", ["serve_dms_compact", "serve_dms_mask"])
def test_serving_dms_kvzap_over_the_mesh_matches_jax_engine(world, label):
    """ServingEngine(mesh=) with DMS(KVzap): answers, stats, host lengths,
    live K/V and keep-masks equal the JAX engine's over its mesh and the
    port's single-process engine's."""
    m = world["m"]
    got = world["got"][label]
    reqs, jpress, _ = _dms_cases(m)[label]
    eng = jserving.ServingEngine(kj.Runner.create(m.cfg_j), m.params_j,
                                 mesh=jmake_mesh(**MESH), press=jpress, **ENGINE)
    view = lambda r: (r["answers"], types.SimpleNamespace(
        last_stats=r["stats"], sc=types.SimpleNamespace(**r["pool"])))
    assert_same((eng.run(requests(jserving, reqs)), eng), view(got))
    assert_same(view(serve(dict(world["jobs"][label][1], mesh=None))), view(got))


def test_dms_and_kvzap_run_under_a_mesh_and_keep_their_item_numbers():
    """Both presses pass ``check_press`` (DMS over KVzap and over Knorm);
    the items after them keep their numbers (18.11, Finch, runs under a
    mesh too)."""
    for press in (kt.KVzapPress(0.5, surrogate=SURROGATES["mlp"]),
                  kt.DMSPress(kt.KVzapPress(surrogate=SURROGATES["linear"])),
                  kt.DMSPress(kt.KnormPress(), decoding=True)):
        check_press(press)
    assert {"DMSPress", "KVzapPress", "FinchPress"} <= set(MESH_PRESSES)
    assert not {"DMSPress", "KVzapPress", "FinchPress"} & set(MESH_ITEMS)
    assert (MESH_ITEMS["RandomPress"], MESH_ITEMS["QFilterPress"],
            MESH_ITEMS["ExpectedAttentionStatsPress"]) == ("18.13", "18.14", "18.16")
