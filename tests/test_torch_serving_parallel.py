"""Tensor-parallel serving of the port (``ServingEngine(mesh=)``,
``KVPressPipeline.batch(mesh=)``) against the JAX engine over the same mesh
(tests/test_serving.py::test_serving_tensor_parallel and its neighbours, at
their tiny shapes), on one gloo world of 4 ranks: data 2 x model 2, the
slots sharded over "data" when they divide, the weights and the pool's kv
heads over "model".

Each engine run is held against the JAX engine over a (data 2, model 2)
mesh and against the port's single-process engine: equal answers, equal
stats, equal host lengths and offsets, live K/V within 1e-5 of their scale
and equal keep-masks (tests/torch_serving_cases.py). Sampling draws equal
the single-process engine's, and a press that does not run under a mesh
raises NotImplementedError naming its ROADMAP item. The ranks run
``tests/torch_parallel_cases.py`` (no JAX there)."""

import types

import jax
import numpy as np
import pytest
import torch

from kvpress_tpu import presses as jp
from kvpress_tpu import serving as jserving
from kvpress_tpu.parallel.mesh import make_mesh as jmake_mesh
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.parallel import MESH_ITEMS
from torch_parallel_cases import batch, run_world, serve
from torch_serving_cases import STATS, Models, assert_same, make_requests, requests
from toy_tokenizer import ToyTokenizer

torch.set_num_threads(2)

MESH = {"data": 2, "model": 2}
ENGINE = dict(n_slots=2, capacity=64, question_bucket=4, fetch_lag=2)


def _decoding(mod, **kw):
    return mod.DecodingPress(base_press=mod.KnormPress(), hidden_states_buffer_size=4, **kw)


def cases(m):
    """{label: (requests, JAX press, port press, engine keywords)}."""
    reqs = make_requests(m.cfg_t.vocab_size, [(32, 4), (40, 8), (24, 4)], n_new=5)
    knorm = (jp.KnormPress(compression_ratio=0.5), kt.KnormPress(0.5))
    return {
        # tests/test_serving.py::test_serving_tensor_parallel
        "knorm": (reqs, *knorm, ENGINE),
        "int8_slots": (reqs, *knorm, dict(ENGINE, quantized=True, kv_bits=8)),
        # 3 slots do not split over data 2: every data shard holds them all
        "replicated": (make_requests(m.cfg_t.vocab_size, [(32, 4), (40, 8), (24, 4), (36, 4)],
                                     n_new=5), *knorm, dict(ENGINE, n_slots=3)),
        "decoding": (make_requests(m.cfg_t.vocab_size, [(40, 4), (32, 4), (48, 4)], n_new=10),
                     _decoding(jp, compression_interval=4, target_size=24),
                     _decoding(kt, compression_interval=4, target_size=24), ENGINE),
        "prefill_decoding": (
            make_requests(m.cfg_t.vocab_size, [(40, 4), (32, 4), (48, 4)], n_new=10),
            *(mod.PrefillDecodingPress(prefilling_press=mod.KnormPress(compression_ratio=0.25),
                                       decoding_press=_decoding(mod, compression_interval=4,
                                                                target_size=24))
              for mod in (jp, kt)), ENGINE),
        "adakv_compact": (reqs, jp.AdaKVPress(jp.KnormPress(compression_ratio=0.5), compact=True),
                          kt.AdaKVPress(kt.KnormPress(0.5), compact=True), ENGINE),
        "chunked_snapkv": (make_requests(m.cfg_t.vocab_size, [(48, 4), (40, 4), (33, 4)],
                                         n_new=5),
                           jp.SnapKVPress(compression_ratio=0.5, window_size=8),
                           kt.SnapKVPress(0.5, window_size=8),
                           dict(ENGINE, context_chunk=16, interleave=True)),
    }


SAMPLING = dict(do_sample=True, temperature=2.0, top_p=0.95, seed=3)
CONTEXTS = [" ".join(f"w{i}" for i in range(n)) for n in (40, 30, 24)]
BATCH = dict(contexts=CONTEXTS, questions=["what ?"] * 3, max_new_tokens=4, n_slots=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every run of the file on one 4-rank world: (models, jobs, results)."""
    m = Models.tiny()
    params = jax.tree_util.tree_map(np.asarray, m.params_j)

    def job(reqs, press, engine):
        return dict(cfg=m.cfg_t, params=params, requests=reqs, mesh=MESH,
                    engine=dict(engine, press=press))

    jobs = {label: ("serve", job(reqs, tp, engine))
            for label, (reqs, _, tp, engine) in cases(m).items()}
    jobs["sampling"] = ("serve", job(cases(m)["knorm"][0], kt.KnormPress(0.5),
                                     dict(ENGINE, **SAMPLING)))
    jobs["batch"] = ("batch", dict(cfg=m.cfg_t, params=params, mesh=MESH,
                                   batch=dict(BATCH, press=kt.KnormPress(0.5))))
    return m, jobs, run_world(4, jobs, tmp_path_factory.mktemp("serving"))


def _engine_view(result):
    """A served result as (answers, an engine-like view) for
    ``torch_serving_cases.assert_same``."""
    return result["answers"], types.SimpleNamespace(last_stats=result["stats"],
                                                    sc=types.SimpleNamespace(**result["pool"]))


def _jax_engine(m, label):
    reqs, jpress, _, engine = cases(m)[label]
    eng = jserving.ServingEngine(m.runners()[0], m.params_j, mesh=jmake_mesh(**MESH),
                                 press=jpress, **engine)
    return eng.run(requests(jserving, reqs)), eng


@pytest.mark.parametrize("label", ["knorm", "int8_slots", "replicated", "decoding",
                                   "prefill_decoding", "adakv_compact", "chunked_snapkv"])
def test_serving_tensor_parallel_matches_jax_engine_over_the_mesh(world, label):
    """data 2 x model 2: answers, stats, host lengths and offsets, live K/V
    and keep-masks equal the JAX engine's over the same mesh and the port's
    single-process engine's."""
    m, jobs, results = world
    got = results[label]
    assert_same(_jax_engine(m, label), _engine_view(got))
    single = serve(dict(jobs[label][1], mesh=None))
    assert_same(_engine_view(single), _engine_view(got))
    assert got["stats"] == single["stats"]


def test_pool_is_sharded_over_data_and_model(world):
    """The rank's pool holds its slot and its kv head: (L, N/2, Hkv/2, C, D);
    3 slots stay whole on every data shard."""
    m, _, results = world
    cfg = m.cfg_t
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    assert results["knorm"]["local_keys"] == (L, 1, H // 2, 64, D)
    assert results["knorm"]["own"] == (0, 1)                 # rank 0: data shard 0
    assert results["replicated"]["local_keys"] == (L, 3, H // 2, 64, D)
    assert results["replicated"]["own"] == (0, 3)


def test_sampling_draws_equal_the_single_process_engine(world):
    """Every rank draws every slot's token from the gathered logits, so the
    draws are the single-process engine's; they are not greedy's."""
    _, jobs, results = world
    single = serve(dict(jobs["sampling"][1], mesh=None))
    assert results["sampling"]["answers"] == single["answers"]
    assert results["sampling"]["answers"] != results["knorm"]["answers"]
    for key in STATS:
        assert results["sampling"]["stats"][key] == single["stats"][key]


def test_pipeline_batch_over_a_mesh(world):
    """KVPressPipeline.batch(mesh=) answers as the single-process batch() and
    as the JAX pipeline's batch(mesh=)."""
    m, jobs, results = world
    job = jobs["batch"][1]
    assert results["batch"] == batch(dict(job, mesh=None))
    kw = dict(BATCH, press=jp.KnormPress(compression_ratio=0.5))
    want = JaxPipeline(m.runners()[0], m.params_j, ToyTokenizer(m.cfg_t.vocab_size)).batch(
        mesh=jmake_mesh(**MESH), **kw)
    assert results["batch"] == want


@pytest.mark.parametrize("make,item", [
    (lambda: kt.KVComposePress(compression_ratio=0.5), "KVComposePress"),
    # ComposedPress runs under a mesh, but not with a stage of a later item.
    (lambda: kt.ComposedPress((kt.KnormPress(0.5), kt.KVzipPress(0.5))), "KVzipPress"),
    (lambda: kt.ComposedPress((kt.KnormPress(0.5), kt.KVComposePress(compression_ratio=0.5))),
     "KVComposePress"),
], ids=["kvcompose", "composed_kvzip", "composed_kvcompose"])
def test_a_press_of_a_later_item_is_refused_over_a_mesh(tmp_path, make, item):
    """A press of class (c) (the KVzip family: budgets over every head of
    every layer), alone or as a stage of ComposedPress, raises
    NotImplementedError naming its ROADMAP item when the engine is made over
    a mesh (a gloo world of one), and when the sharded Runner prefills with
    it."""
    import torch.distributed as dist

    from kvpress_tpu_torch.parallel import make_mesh, shard_params

    m = Models.tiny()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, 1)
        with pytest.raises(NotImplementedError, match=f"item {MESH_ITEMS[item]} "):
            kt.ServingEngine(m.runners()[1], m.params_t, press=make(), mesh=mesh, **ENGINE)
        runner = kt.Runner.create(m.cfg_t, device="cpu", mesh=mesh)
        ids = torch.arange(3, 35)[None]
        with pytest.raises(NotImplementedError, match=f"item {MESH_ITEMS[item]} "):
            runner.prefill(shard_params(m.params_t, mesh), ids, press=make())
        eng = kt.ServingEngine(m.runners()[1], m.params_t, press=kt.KnormPress(0.5),
                               mesh=mesh, **ENGINE)
        assert eng.runner.shard.size == 1 and eng.own == slice(0, 2)
    finally:
        dist.destroy_process_group()
