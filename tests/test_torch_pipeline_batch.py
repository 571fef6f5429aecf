"""``KVPressPipeline.batch()`` of kvpress_tpu_torch (CPU, float32, tiny
models): against the port's per-request ``__call__`` and against the JAX
pipeline's ``batch()`` on the same weights and tokenizer; KVzip's multi-pass
admission (one-shot and chunked) and a DecodingPress through it; the default
capacity; a tiny Gemma3-like multimodal model with images, mixed with a
text-only request, one-shot and chunked, and the context LRU keyed on the
pixels' SHA-1."""

import re

import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import presses as jp
from kvpress_tpu import serving as jserving
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
from test_torch_multimodal import IMAGE_TOKEN_ID, ImageTokenizer, mm  # noqa: F401 (fixture)
from toy_tokenizer import ToyTokenizer
from torch_serving_cases import Models, assert_teacher_forced

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pipes():
    m = Models.tiny()
    tok = ToyTokenizer(m.cfg_t.vocab_size)
    return dict(m=m, jax=JaxPipeline(kj.Runner.create(m.cfg_j), m.params_j, tok),
                torch=kt.KVPressPipeline(kt.Runner.create(m.cfg_t, device="cpu"), m.params_t,
                                         tok),
                flash=kt.KVPressPipeline(kt.Runner.create(m.cfg_t, attn_impl="flash",
                                                          decode_kernel=True, device="cpu"),
                                         m.params_t, tok))


CONTEXTS = [" ".join(f"w{i}x{j}" for i in range(24 + 8 * j)) for j in range(4)]
QUESTIONS = [f"what is w3x{j} ?" for j in range(4)]


def _ids(tok, answer):
    """An answer's token ids (ToyTokenizer decodes an unseen id as <id>)."""
    return [int(t[1:-1]) if re.fullmatch(r"<\d+>", t) else tok._tok2id(t)
            for t in answer.split()]


@pytest.mark.parametrize("route", ["torch", "flash"])
def test_batch_matches_call_and_jax(pipes, route):
    """Mixed context lengths through two slots: the JAX batch()'s answers,
    each teacher-forced against the single-request path, and __call__'s."""
    pipe, press = pipes[route], kt.KnormPress(0.5)
    got = pipe.batch(CONTEXTS, QUESTIONS, press=press, max_new_tokens=6, n_slots=2,
                     question_bucket=4)
    want = pipes["jax"].batch(CONTEXTS, QUESTIONS, press=kj.KnormPress(0.5), max_new_tokens=6,
                              n_slots=2, question_bucket=4)
    if route == "torch":
        assert got == want
    for ctx, q, answer in zip(CONTEXTS, QUESTIONS, got):
        toks = _ids(pipe.tokenizer, answer)
        assert len(toks) == 6, answer
        ctx_ids, q_ids = pipe.preprocess(ctx, [q])
        assert_teacher_forced(pipe.runner, pipe.params, press, (ctx_ids, q_ids[0]), toks)
        assert answer == pipe(ctx, question=q, press=press, max_new_tokens=6)["answer"]


def test_batch_default_capacity_as_jax(pipes, monkeypatch):
    """The kept bound of the longest context, the bucketed longest question,
    the generation room and one slot; n_slots no more than the requests."""
    seen = {}
    for name, mod in (("torch", kt.serving), ("jax", jserving)):
        original = mod.ServingEngine.__init__

        def record(self, *a, original=original, name=name, **kw):
            seen[name] = (kw["capacity"], kw["n_slots"])
            original(self, *a, **kw)

        monkeypatch.setattr(mod.ServingEngine, "__init__", record)
    pipes["torch"].batch(CONTEXTS[:3], QUESTIONS[:3], press=kt.KnormPress(0.25),
                         max_new_tokens=3, context_bucket=16)
    pipes["jax"].batch(CONTEXTS[:3], QUESTIONS[:3], press=kj.KnormPress(0.25),
                       max_new_tokens=3, context_bucket=16)
    assert seen["torch"] == seen["jax"] == (int((40 + 8) * 0.75) + 64 + 3 + 1, 3)


def test_batch_kvzip_and_decoding_press_match_jax(pipes):
    """KVzip's multi-pass admission (the tokenizer passed on), one-shot and
    chunked (the same answers), and a DecodingPress served per slot."""
    ctxs = [" ".join(f"tok{i}" for i in range(n)) for n in (30, 24)]
    kw = dict(questions=["what ?"] * 2, max_new_tokens=4, capacity=96, n_slots=2)
    ans = pipes["torch"].batch(ctxs, press=kt.KVzipPress(0.5, chunk_size=16), **kw)
    assert ans == pipes["jax"].batch(ctxs, press=jp.KVzipPress(0.5, chunk_size=16), **kw)
    assert all(isinstance(a, str) and a for a in ans)
    assert pipes["torch"].batch(ctxs, press=kt.KVzipPress(0.5, chunk_size=16),
                                context_chunk=16, **kw) == ans
    press = {mod: mod.DecodingPress(base_press=mod.KnormPress(), compression_interval=4,
                                    target_size=24, hidden_states_buffer_size=4)
             for mod in (jp, kt)}
    kw = dict(questions=["what ?"] * 2, max_new_tokens=6, n_slots=2)
    assert pipes["torch"].batch(ctxs, press=press[kt], **kw) == \
        pipes["jax"].batch(ctxs, press=press[jp], **kw)


def test_batch_streams_its_answers(pipes):
    streamed = {}
    got = pipes["torch"].batch(CONTEXTS[:2], QUESTIONS[:2], press=kt.KnormPress(0.5),
                               max_new_tokens=5, on_token=lambda i, t, n: streamed.setdefault(
                                   i, []).append(t))
    tok = pipes["torch"].tokenizer
    assert [tok.decode(streamed[i], skip_special_tokens=True) for i in range(2)] == got


# --------------------------------------------------------------------- #
# Multimodal


@pytest.fixture(scope="module")
def mm_pipes(mm):
    tok = ImageTokenizer(vocab_size=498)
    jpipe = JaxPipeline(kj.Runner.create(mm["cfg_j"], attn_impl="xla"), mm["params_j"], tok,
                        vision_params=mm["embed_j"].vparams, vision_cfg=mm["embed_j"].vcfg,
                        image_token_id=IMAGE_TOKEN_ID)
    tpipe = kt.KVPressPipeline(kt.Runner.create(mm["cfg_t"], device="cpu"), mm["params_t"], tok,
                               vision_params=mm["tower"], vision_cfg=mm["tower"].vcfg,
                               image_token_id=IMAGE_TOKEN_ID)
    rng = np.random.default_rng(3)
    words = " ".join(f"w{i}" for i in range(10))
    return dict(jax=jpipe, torch=tpipe,
                mm_ctx=f"{words} <image> <image> <image> <image> tail0 tail1",
                txt_ctx=" ".join(f"t{i}" for i in range(18)),
                px=rng.standard_normal((1, 3, 28, 28)).astype(np.float32),
                px2=rng.standard_normal((1, 3, 28, 28)).astype(np.float32))


@pytest.mark.parametrize("chunk", [None, 8])
def test_multimodal_batch_matches_call_and_jax(mm_pipes, chunk):
    """A request with an image beside a text-only one: each answer that of
    the single-request pipeline, and the JAX batch()'s."""
    p = mm_pipes
    press = kt.KnormPress(compression_ratio=0.25)
    singles = [p["torch"](p["mm_ctx"], question="q0 q1", pixel_values=p["px"], press=press,
                          max_new_tokens=5)["answer"],
               p["torch"](p["txt_ctx"], question="q0 q1", press=press,
                          max_new_tokens=5)["answer"]]
    kw = dict(questions=["q0 q1"] * 2, max_new_tokens=5, n_slots=2,
              pixel_values=[p["px"], None], context_chunk=chunk)
    got = p["torch"].batch([p["mm_ctx"], p["txt_ctx"]], press=press, **kw)
    assert got == singles
    assert got == p["jax"].batch([p["mm_ctx"], p["txt_ctx"]],
                                 press=kj.KnormPress(compression_ratio=0.25), **kw)


def test_multimodal_context_cache_keyed_on_the_pixels(mm_pipes, monkeypatch):
    """The same context ids with the same image hit the LRU; with another
    image they miss (the SHA-1 of the pixels is part of the key)."""
    p = mm_pipes
    hits = []
    original = kt.ServingEngine.run

    def run(self, *a, **kw):
        out = original(self, *a, **kw)
        hits.append(self.last_stats["ctx_hits"])
        return out

    monkeypatch.setattr(kt.ServingEngine, "run", run)
    kw = dict(questions=["q0 q1", "q1 q0", "q0 q1"], max_new_tokens=4, n_slots=1,
              context_cache=2, press=kt.KnormPress(0.25))
    got = p["torch"].batch([p["mm_ctx"]] * 3, pixel_values=[p["px"], p["px"], p["px2"]], **kw)
    assert hits == [1]
    kw["press"] = kj.KnormPress(0.25)
    assert got == p["jax"].batch([p["mm_ctx"]] * 3, pixel_values=[p["px"], p["px"], p["px2"]],
                                 **kw)
    assert got[0] == p["torch"](p["mm_ctx"], question="q0 q1", pixel_values=p["px"],
                                press=kt.KnormPress(0.25), max_new_tokens=4)["answer"]
    assert got[2] == p["torch"](p["mm_ctx"], question="q0 q1", pixel_values=p["px2"],
                                press=kt.KnormPress(0.25), max_new_tokens=4)["answer"]
