"""The shard-local presses of ROADMAP Queue A items 18.1-18.11 served over a
tensor-parallel mesh: ``ServingEngine(mesh=)`` and
``KVPressPipeline.batch(mesh=)`` on a gloo world of 2 ranks ("model" 2 on
the tiny config with GQA 8/4, two kv heads a rank), each press against the
JAX engine on the same requests and the port's single-process engine and
``batch()``.

Held to tests/test_torch_serving_parallel.py's limits: equal answers, equal
stats, equal host lengths and offsets, live K/V within 1e-5 of their scale
and equal keep-masks (tests/torch_serving_cases.py); ``batch(mesh=)``
answers the single-process ``batch()`` and the JAX engine's answers
decoded. The single-process engine admits every one of the 11 one-shot;
with ``context_chunk`` it refuses Merging and Block (and CAP's chunked
prefill raises), and the mesh gives the same refusals. The ranks run
``tests/torch_parallel_cases.py`` (no JAX there)."""

import types

import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import serving as jserving
import kvpress_tpu_torch as kt
from test_torch_parallel import numpy_tree
from test_torch_parallel_local_presses import OVER, PRESSES, _models, _sketches
from toy_tokenizer import ToyTokenizer
from torch_parallel_cases import batch, finish_world, serve, start_world
from torch_scorer_cases import distinct_words
from torch_serving_cases import assert_same, requests

torch.set_num_threads(2)

MESH = {"data": 1, "model": 2}
NEW = 5
# One case of each of the 11; the engine as batch() makes it.
SERVED = ("cap", "cur", "critical_knorm", "key_rerotation", "per_layer", "think", "chunk",
          "composed", "merging", "block_keydiff", "finch")
SLOTS = {"dense": {}, "int8": dict(quantized=True, kv_bits=8)}
CASES = [(p, "dense") for p in SERVED] + [(p, "int8") for p in ("critical_knorm",
                                                                "key_rerotation")]
ENGINE = dict(n_slots=2, capacity=64, question_bucket=4)
# context_chunk admission: refused at the engine (Merging, Block) or by the
# chunked prefill (CAP), on one process and over the mesh alike.
REFUSED = ("cap", "merging", "block_keydiff")


def _texts():
    """Three (context, question) pairs of distinct words (a repeated token's
    keys tie under Knorm, and two packages round them apart after RoPE)."""
    words = distinct_words(ToyTokenizer(kt.tiny_config().vocab_size), 130)
    contexts = [" ".join(words[a:a + n]) for a, n in ((0, 40), (40, 30), (70, 44))]
    return contexts, [f"what is {w} ?" for w in (words[3], words[45], words[90])]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg_j, cfg_t, params, _ = _models()
    tree = numpy_tree(params)
    tok = ToyTokenizer(cfg_t.vocab_size)
    pipe = kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"),
                              kt.params_from_jax(tree, cfg_t, device="cpu",
                                                 dtype=torch.float32), tok)
    contexts, questions = _texts()
    reqs = []
    for c, q in zip(contexts, questions):
        ctx_ids, q_ids = pipe.preprocess(c, [q])
        reqs.append((ctx_ids, q_ids[0], NEW))
    eos = tuple(e for e in pipe._eos() if e >= 0)

    def job(label, slots, **engine):
        j = dict(cfg=cfg_t, params=tree, requests=reqs, mesh=MESH,
                 engine=dict(ENGINE, eos_ids=eos, press=PRESSES[label](kt), **SLOTS[slots],
                             **engine))
        if label == "cur":
            j["sketches"] = _sketches(cfg_t)
        return j

    jobs = {f"{label}-{slots}": ("serve", job(label, slots)) for label, slots in CASES}
    for label in SERVED:
        j = job(label, "dense")
        jobs[f"{label}-batch"] = ("batch", dict(j, batch=dict(
            contexts=contexts, questions=questions, press=j["engine"]["press"],
            max_new_tokens=NEW, **ENGINE)))
    for label in REFUSED:
        jobs[f"{label}-refused"] = ("refused", dict(kind="serve", mesh=MESH, job=job(
            label, "dense", context_chunk=16)))
    handle = start_world(2, jobs, tmp_path_factory.mktemp("served"))

    def jax_engine(label, slots):
        eng = jserving.ServingEngine(kj.Runner.create(cfg_j), params, eos_ids=eos,
                                     press=PRESSES[label](kj), **ENGINE, **SLOTS[slots])
        return eng.run(requests(jserving, reqs)), eng

    want = {k: jax_engine(*k) for k in CASES}
    return dict(jobs=jobs, want=want, tok=tok, got=finish_world(handle))


def _view(result):
    """A served result as (answers, an engine-like view) for
    ``torch_serving_cases.assert_same``."""
    return result["answers"], types.SimpleNamespace(last_stats=result["stats"],
                                                    sc=types.SimpleNamespace(**result["pool"]))


@pytest.mark.parametrize("label,slots", CASES, ids=[f"{p}-{s}" for p, s in CASES])
def test_engine_over_the_mesh_matches_jax_engine(world, label, slots):
    """model 2: answers, stats, host lengths and offsets, live K/V and
    keep-masks equal the JAX engine's and the port's single-process
    engine's."""
    got = world["got"][f"{label}-{slots}"]
    assert_same(world["want"][(label, slots)], _view(got))
    single = serve(dict(world["jobs"][f"{label}-{slots}"][1], mesh=None))
    assert_same(_view(single), _view(got))
    assert got["stats"] == single["stats"]
    assert got["local_keys"][2] == OVER["num_kv_heads"] // 2


@pytest.mark.parametrize("label", SERVED)
def test_batch_over_the_mesh_answers_as_one_process_and_jax(world, label):
    """``batch(mesh=)`` answers as the single-process ``batch()`` and as the
    JAX engine on the same requests, decoded."""
    got = world["got"][f"{label}-batch"]
    assert got == batch(dict(world["jobs"][f"{label}-batch"][1], mesh=None))
    answers, _ = world["want"][(label, "dense")]
    assert got == [world["tok"].decode(a, skip_special_tokens=True) for a in answers]


@pytest.mark.parametrize("label", REFUSED)
def test_chunked_admission_refusal_is_the_single_process_one(world, label):
    """With ``context_chunk`` the engine over the mesh refuses Merging and
    Block (and CAP's chunked prefill raises) as the single-process engine
    does."""
    job = world["jobs"][f"{label}-refused"][1]["job"]
    with pytest.raises((ValueError, TypeError)) as single:
        serve(dict(job, mesh=None))
    assert world["got"][f"{label}-refused"] == f"{single.typename}: {single.value}"
