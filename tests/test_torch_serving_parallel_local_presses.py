"""The shard-local presses of ROADMAP Queue A items 18.1-18.11, the
head-indexed ones of items 18.13, 18.14, 18.16 and 18.17 (Random, QFilter,
ExpectedAttentionStats, DuoAttention), three cross-head ones of items
18.20, 18.21 and 18.24 (TOVA, CriticalAdaKV, SimLayerKV) and the
normalized scorers of items 18.25-18.27 (Compactor, LeverageScore,
NonCausalAttn; LeverageScore and Compactor on the JAX package's sketches)
served over a tensor-parallel mesh:
``ServingEngine(mesh=)`` and ``KVPressPipeline.batch(mesh=)`` on a gloo
world of 2 ranks ("model" 2 on the tiny config with GQA 8/4, two kv heads a
rank), each press against the JAX engine on the same requests (Random, whose
draws are torch's: not) and the port's single-process engine and
``batch()``.

Held to tests/test_torch_serving_parallel.py's limits: equal answers, equal
stats, equal host lengths and offsets, live K/V within 1e-5 of their scale
and equal keep-masks (tests/torch_serving_cases.py); ``batch(mesh=)``
answers the single-process ``batch()`` and the JAX engine's answers
decoded. The single-process engine admits every one of the 11 one-shot;
with ``context_chunk`` it refuses Merging and Block (and CAP's chunked
prefill raises), and the mesh gives the same refusals. CAM (item 18.28)
merges values in the decode steps, which the serving loop does not run:
the engine over the mesh refuses it with the single-process error. The
ranks run ``tests/torch_parallel_cases.py`` (no JAX there)."""

import pickle
import types

import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import serving as jserving
import kvpress_tpu_torch as kt
from test_torch_parallel import numpy_tree
from test_torch_parallel_local_presses import (ALL_PRESSES, OVER, _leverage_sketches, _models,
                                               _sketches)
from toy_tokenizer import ToyTokenizer
from torch_parallel_cases import batch, finish_world, serve, start_world
from torch_scorer_cases import distinct_words
from torch_serving_cases import assert_same, requests

torch.set_num_threads(2)

MESH = {"data": 1, "model": 2}
NEW = 5
# One case of each of the 11, the head-indexed four, three cross-head
# presses and the three normalized scorers; the engine as batch() makes it.
SERVED = ("cap", "cur", "critical_knorm", "key_rerotation", "per_layer", "think", "chunk",
          "composed", "merging", "block_keydiff", "finch",
          "qfilter", "expected_attention_stats", "duo", "random",
          "tova", "critical_ada_knorm", "simlayerkv",
          "compactor", "leverage", "noncausal")
# SimLayerKV's lazy scores on the three contexts (layers 0, 1) are 0.520 and
# 0.562 (40 tokens), 0.695 and 0.695 (30), 0.470 and 0.429 (44): at 0.54
# the first has layer 1 lazy alone, the second both, the third neither.
PRESSES = dict(ALL_PRESSES,
               simlayerkv=lambda m: m.SimLayerKVPress(lazy_threshold=0.54, n_recent=16))
SLOTS = {"dense": {}, "int8": dict(quantized=True, kv_bits=8)}
CASES = [(p, "dense") for p in SERVED] + [(p, "int8") for p in (
    "critical_knorm", "key_rerotation", "qfilter", "expected_attention_stats", "duo", "random")]
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
        if label in ("compactor", "leverage"):
            # Each admission prefills a batch of one.
            j["leverage"] = _leverage_sketches(cfg_t, j["engine"]["press"])
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
    jobs["cam_knorm-refused"] = ("refused", dict(kind="serve", mesh=MESH,
                                                 job=job("cam_knorm", "dense")))
    handle = start_world(2, jobs, tmp_path_factory.mktemp("served"))

    def jax_engine(label, slots):
        eng = jserving.ServingEngine(kj.Runner.create(cfg_j), params, eos_ids=eos,
                                     press=PRESSES[label](kj), **ENGINE, **SLOTS[slots])
        return eng.run(requests(jserving, reqs)), eng

    want = {k: jax_engine(*k) for k in CASES if k[0] != "random"}
    return dict(jobs=jobs, want=want, tok=tok, got=finish_world(handle))


def _fresh(job):
    """A copy of ``job`` for the single process, as the ranks unpickled it
    (RandomPress's generator at its seed)."""
    return dict(pickle.loads(pickle.dumps(job)), mesh=None)


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
    if label != "random":
        assert_same(world["want"][(label, slots)], _view(got))
    single = serve(_fresh(world["jobs"][f"{label}-{slots}"][1]))
    assert_same(_view(single), _view(got))
    assert got["stats"] == single["stats"]
    assert got["local_keys"][2] == OVER["num_kv_heads"] // 2


@pytest.mark.parametrize("label", SERVED)
def test_batch_over_the_mesh_answers_as_one_process_and_jax(world, label):
    """``batch(mesh=)`` answers as the single-process ``batch()`` and as the
    JAX engine on the same requests, decoded."""
    got = world["got"][f"{label}-batch"]
    assert got == batch(_fresh(world["jobs"][f"{label}-batch"][1]))
    if label == "random":
        return
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


def test_cam_engine_over_the_mesh_is_refused_as_on_one_process(world):
    """CAM merges values in its decode steps: ``ServingEngine(CAMPress(...),
    mesh=)`` raises the single-process engine's ValueError (before the mesh
    gate)."""
    job = world["jobs"]["cam_knorm-refused"][1]["job"]
    with pytest.raises(ValueError) as single:
        serve(dict(job, mesh=None))
    assert world["got"]["cam_knorm-refused"] == f"{single.typename}: {single.value}"
    assert "CAM" in str(single.value)
