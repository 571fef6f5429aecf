"""Text-generation pipeline: compress a long context once, answer many
questions against the compressed cache (port of ``kvpress_tpu/pipeline.py``,
single-pass path).

Chat-template separator split, one compressing prefill, ``resize`` of the
cache, then per question a question forward and greedy (or nucleus) decode
with positions continuing from the uncompressed context length, and a
rollback between questions: restoring the pre-question ``length``/``offset``
(the runner leaves the caller's copies untouched).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

from .cache import resize
from .device import DeviceLike
from .models.llama import LlamaModel, Runner
from .presses.base import BasePress

logger = logging.getLogger(__name__)


def _sample_token(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float, top_p: float) -> int:
    """Nucleus sampling of one token from (V,) logits."""
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    sorted_probs, order = torch.sort(probs, descending=True)
    keep = torch.cumsum(sorted_probs, dim=0) - sorted_probs < top_p   # keeps the top token
    filtered = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    idx = torch.multinomial(filtered, 1, generator=generator)
    return int(order[idx])


def _generate_answer(
    runner: Runner,
    params: LlamaModel,
    question_ids: torch.Tensor,          # (1, Tq); Tq may be 0
    cache,
    prefill_logits: torch.Tensor,
    *,
    max_new_tokens: int,
    eos_ids: tuple[int, ...],
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> tuple[list[int], object]:
    """Question forward, then decode until ``max_new_tokens`` or an EOS.
    Returns (generated tokens, final cache). An empty question starts from
    the prefill's logits."""
    if question_ids.shape[1] > 0:
        logits, cache, _ = runner.forward(params, question_ids, cache,
                                          logits_last_only=True, phase="decode")
    else:
        logits = prefill_logits

    def pick(row):
        if do_sample:
            return _sample_token(row, generator, temperature, top_p)
        return int(torch.argmax(row))

    tok = pick(logits[0, -1])
    out = [tok]
    while len(out) < max_new_tokens and tok not in eos_ids:
        ids = torch.tensor([[tok]], dtype=torch.long, device=question_ids.device)
        logits, cache, _ = runner.forward(params, ids, cache, logits_last_only=True,
                                          phase="decode")
        tok = pick(logits[0, -1])
        out.append(tok)
    return out, cache


def _chat_affixes(tok) -> tuple[int, list[int]]:
    """(prefix_len, suffix_ids) of the chat template around a user message,
    probed with a dummy separator (reference kvzip_press.py:96-117)."""
    if tok.chat_template is None:
        return 0, tok.encode("\n", add_special_tokens=False)
    dummy = "dummy context"
    separator = "\n" + "#" * len(dummy)
    templated = tok.apply_chat_template(
        [{"role": "user", "content": dummy + separator}],
        add_generation_prompt=True, tokenize=False, enable_thinking=False,
    )
    ctx_part, suffix_text = templated.split(separator)
    prefix_len = len(tok.encode(ctx_part.split(dummy)[0], add_special_tokens=False))
    return prefix_len, tok.encode(suffix_text, add_special_tokens=False)


@dataclasses.dataclass
class KVPressPipeline:
    """Callable: pipe(context, question=..., press=...) -> {"answer": str}.

    Runs on the runner's device (``Runner.create(..., device=...)``);
    ``params`` must live there too."""

    runner: Runner
    params: LlamaModel
    tokenizer: object
    eos_token_ids: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        if self.params.device != self.runner.device:
            raise ValueError(f"params on {self.params.device}, runner on "
                             f"{self.runner.device}")

    @property
    def device(self) -> torch.device:
        return self.runner.device

    @staticmethod
    def from_pretrained(path: str, dtype: torch.dtype = torch.bfloat16,
                        device: DeviceLike = "cuda") -> "KVPressPipeline":
        from transformers import AutoTokenizer

        from .models.convert import load_pretrained

        params, cfg = load_pretrained(path, dtype=dtype, device=device)
        tok = AutoTokenizer.from_pretrained(path)
        return KVPressPipeline(Runner.create(cfg, device=device), params, tok)

    def _eos(self) -> tuple[int, ...]:
        if self.eos_token_ids is not None:
            return tuple(self.eos_token_ids)
        eos = self.tokenizer.eos_token_id
        if eos is None:
            return (-1,)
        return tuple(eos) if isinstance(eos, (list, tuple)) else (int(eos),)

    def preprocess(
        self,
        context: str,
        questions: list[str],
        answer_prefix: str = "",
        max_context_length: Optional[int] = None,
        enable_thinking: bool = False,
    ):
        tok = self.tokenizer
        if tok.chat_template is None:
            context = (getattr(tok, "bos_token", "") or "") + context
            question_suffix = "\n"
        else:
            separator = "#" * (len(context) + 10)
            templated = tok.apply_chat_template(
                [{"role": "user", "content": context + separator}],
                add_generation_prompt=True, tokenize=False,
                enable_thinking=enable_thinking,
            )
            context, question_suffix = templated.split(separator)
        questions = [q + question_suffix + answer_prefix for q in questions]
        context_ids = tok.encode(context, add_special_tokens=False)
        if max_context_length is not None and len(context_ids) > max_context_length:
            logger.warning("Context length has been truncated from %d to %d tokens.",
                           len(context_ids), max_context_length)
            context_ids = context_ids[:max_context_length]
        question_ids = [tok.encode(q, add_special_tokens=False) for q in questions]
        return context_ids, question_ids

    @torch.no_grad()
    def __call__(
        self,
        context: str,
        question: Optional[str] = None,
        questions: Optional[list[str]] = None,
        press: Optional[BasePress] = None,
        max_new_tokens: int = 50,
        answer_prefix: str = "",
        max_context_length: Optional[int] = None,
        enable_thinking: bool = False,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
        context_bucket: Optional[int] = None,
        context_chunk: Optional[int] = None,
        quantized: bool = False,     # int KV cache (reference: cache=QuantizedCache())
        kv_bits: int = 8,            # 8 (int8) or 4 (packed nibbles)
        pixel_values=None,
    ) -> dict:
        if question is not None and questions is not None:
            raise ValueError("Either question or questions should be provided, not both.")
        if context_bucket is not None or context_chunk is not None:
            raise NotImplementedError("bucketed and chunked prefill come with ROADMAP "
                                      "Queue A items 8 and 10")
        if pixel_values is not None:
            raise NotImplementedError("multimodal input comes with ROADMAP Queue A item 15")
        single = questions is None
        questions = questions or ([question] if question else [""])
        if do_sample and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)

        context_ids, question_ids = self.preprocess(
            context, questions, answer_prefix, max_context_length, enable_thinking)
        context_length = len(context_ids)
        ids = torch.tensor([context_ids], dtype=torch.long, device=self.device)
        prefill_logits, cache, _ = self.runner.prefill(
            self.params, ids, press=press, compute_logits=True, dtype=self.params.dtype,
            quantized=quantized, kv_bits=kv_bits)
        compressed = int(cache.length.max())
        logger.debug("Context Length: %d", context_length)
        logger.debug("Compressed Context Length: %d", compressed)

        # Re-bucket the cache to realize the compression's memory saving, with
        # room for the longest question and its generation.
        kept = (press.max_kept(context_length, self.runner.cfg)
                if press is not None else context_length)
        kept = min(kept, compressed)
        max_q = max((len(q) for q in question_ids), default=0)
        cache = resize(cache, kept + max_q + max_new_tokens + 1)

        base_length, base_offset = cache.length, cache.offset
        answers = []
        for q_ids in question_ids:
            q = torch.tensor([q_ids], dtype=torch.long, device=self.device).reshape(1, -1)
            tokens, _ = _generate_answer(
                self.runner, self.params, q, cache, prefill_logits,
                max_new_tokens=max_new_tokens, eos_ids=self._eos(),
                do_sample=do_sample, temperature=temperature, top_p=top_p,
                generator=generator,
            )
            answers.append(self.tokenizer.decode(tokens, skip_special_tokens=True))
            # Rollback: slots past the restored length are stale and are
            # overwritten by the next question's append.
            cache = dataclasses.replace(cache, length=base_length, offset=base_offset)
        if single:
            return {"answer": answers[0]}
        return {"answers": answers}

    def batch(self, *args, **kwargs):
        raise NotImplementedError("batched serving comes with ROADMAP Queue A item 14")
