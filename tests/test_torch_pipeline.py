"""kvpress_tpu_torch.KVPressPipeline against kvpress_tpu.pipeline on the same
weights and tests/toy_tokenizer.py: the same greedy answers with
KnormPress(0.5) for bf16, int8 and int4 KV (CPU, float32, tiny config)."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.models.llama import quantize_params_int4 as jquant4
from kvpress_tpu.models.llama import quantize_params_int8 as jquant8
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.models.llama import quantize_params_int4 as tquant4
from kvpress_tpu_torch.models.llama import quantize_params_int8 as tquant8
from toy_tokenizer import ToyTokenizer

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _unique_words(tok, n):
    """n words whose toy-token ids are distinct (distinct ids keep Knorm
    scores untied, so XLA and torch keep the same entries)."""
    seen, words, i = set(), [], 0
    while len(words) < n:
        w = f"word{i}"
        i += 1
        t = tok.encode(w)[0]
        if t not in seen:
            seen.add(t)
            words.append(w)
    return words


@pytest.fixture(scope="module")
def pipes():
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    tok = ToyTokenizer(cfg_j.vocab_size)
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu", dtype=torch.float32)
    words = _unique_words(tok, 48)
    context = " ".join(words[:40])
    questions = ["what is " + words[40] + " ?", " ".join(words[41:48])]
    return dict(
        jax=JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok),
        torch=kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), params_t, tok),
        jax8=JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), jquant8(params_j), tok),
        torch8=kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), tquant8(params_t),
                                  tok),
        jax4=JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), jquant4(params_j), tok),
        torch4=kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), tquant4(params_t),
                                  tok),
        context=context, questions=questions,
    )


@pytest.mark.parametrize("kv", [{}, dict(quantized=True, kv_bits=8),
                                dict(quantized=True, kv_bits=4)],
                         ids=["bf16kv", "int8kv", "int4kv"])
def test_same_greedy_answers_as_jax(pipes, kv):
    kw = dict(questions=pipes["questions"], press=kt.KnormPress(0.5), max_new_tokens=8, **kv)
    got = pipes["torch"](pipes["context"], **kw)["answers"]
    kw["press"] = kj.KnormPress(0.5)
    want = pipes["jax"](pipes["context"], **kw)["answers"]
    assert got == want
    assert all(len(a.split()) == 8 for a in got)


def test_int8_weights_int4_kv_same_answers_as_jax(pipes):
    kw = dict(question=pipes["questions"][0], max_new_tokens=8, quantized=True, kv_bits=4)
    got = pipes["torch8"](pipes["context"], press=kt.KnormPress(0.5), **kw)["answer"]
    want = pipes["jax8"](pipes["context"], press=kj.KnormPress(0.5), **kw)["answer"]
    assert got == want


def test_int4_weights_int4_kv_same_answers_as_jax(pipes):
    kw = dict(questions=pipes["questions"], max_new_tokens=8, quantized=True, kv_bits=4)
    got = pipes["torch4"](pipes["context"], press=kt.KnormPress(0.5), **kw)["answers"]
    want = pipes["jax4"](pipes["context"], press=kj.KnormPress(0.5), **kw)["answers"]
    assert got == want


def test_logs_and_rollback(pipes, caplog):
    pipe = pipes["torch"]
    with caplog.at_level(logging.DEBUG, logger="kvpress_tpu_torch.pipeline"):
        joint = pipe(pipes["context"], questions=pipes["questions"],
                     press=kt.KnormPress(0.4), max_new_tokens=6)["answers"]
    messages = [r.getMessage() for r in caplog.records]
    assert "Context Length: 40" in messages
    assert "Compressed Context Length: 24" in messages
    solo = [pipe(pipes["context"], question=q, press=kt.KnormPress(0.4),
                 max_new_tokens=6)["answer"] for q in pipes["questions"]]
    assert joint == solo


def test_no_press_and_empty_question_match_jax(pipes):
    got = pipes["torch"](pipes["context"], max_new_tokens=5)["answer"]
    want = pipes["jax"](pipes["context"], max_new_tokens=5)["answer"]
    assert got == want


def test_sampling_is_seeded(pipes):
    pipe = pipes["torch"]
    kw = dict(question=pipes["questions"][0], press=kt.KnormPress(0.5), max_new_tokens=6,
              do_sample=True, temperature=0.8, top_p=0.9)
    a = pipe(pipes["context"], seed=3, **kw)["answer"]
    b = pipe(pipes["context"], generator=torch.Generator().manual_seed(3), **kw)["answer"]
    assert a == b and len(a.split()) == 6


def test_sampled_answer_does_not_depend_on_earlier_questions(pipes):
    """Each question draws from its own generator: the answer to b is the
    same after a as after c, though a's and c's answers differ in length (a
    third of the vocabulary ends an answer, so lengths vary)."""
    base = pipes["torch"]
    pipe = kt.KVPressPipeline(base.runner, base.params, base.tokenizer,
                              eos_token_ids=tuple(range(0, base.runner.cfg.vocab_size, 3)))
    a, b = pipes["questions"]
    c = "what is " + pipes["context"].split()[7] + " ?"
    kw = dict(press=kt.KnormPress(0.5), max_new_tokens=12, do_sample=True, temperature=1.5,
              seed=11)
    first = pipe(pipes["context"], questions=[a, b], **kw)["answers"]
    second = pipe(pipes["context"], questions=[c, b], **kw)["answers"]
    assert len(first[0].split()) != len(second[0].split())
    assert first[1] == second[1]


def test_options_of_later_slices_raise(pipes):
    # context_bucket is ported (tests/test_torch_bucketing.py), batch() too
    # (tests/test_torch_pipeline_batch.py), and batch(mesh=) over a
    # torch.distributed DeviceMesh (tests/test_torch_serving_parallel.py):
    # any other mesh is refused.
    with pytest.raises(TypeError, match="DeviceMesh"):
        pipes["torch"].batch([pipes["context"]], mesh=object())
