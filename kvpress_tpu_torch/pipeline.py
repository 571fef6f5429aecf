"""Text-generation pipeline: compress a long context once, answer many
questions against the compressed cache (port of ``kvpress_tpu/pipeline.py``,
single-pass path).

Chat-template separator split (and FinchPress's delimiter, found and
stripped on the host), one compressing prefill (whole, padded to a multiple
of ``context_bucket`` tokens, or in chunks of ``context_chunk`` tokens), the
head-wise compaction of a ``host_compact`` press (``cache.compact_masked``),
``resize`` of the cache, then per question a
question forward and greedy (or nucleus) decode with positions continuing
from the uncompressed context length, and a rollback between questions:
restoring the pre-question ``length``/``offset`` (the runner leaves the
caller's copies untouched). Nucleus sampling draws from one generator a
question, seeded before the first question.

A multimodal pipeline (``from_torch_multimodal``, or ``vision_params``,
``vision_cfg`` and ``image_token_id`` given) takes ``pixel_values``: the
vision tower's features replace the context's image placeholders
(``convert.multimodal_embeds``), and the prefill lets the tokens of one
image attend each other (``token_types``), one-shot or chunked.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

from .cache import compact_masked, resize
from .device import DeviceLike
from .models.llama import LlamaModel, Runner
from .models.siglip import VisionConfig, VisionTower
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
    # Multimodal (Gemma3): the vision tower with its projector, its config,
    # and the placeholder id each image expands to (mm_tokens_per_image
    # copies of it in the context, the HF processor contract).
    vision_params: Optional[VisionTower] = None
    vision_cfg: Optional[VisionConfig] = None
    image_token_id: Optional[int] = None

    def __post_init__(self):
        for name, p in (("params", self.params), ("vision_params", self.vision_params)):
            if p is not None and p.device != self.runner.device:
                raise ValueError(f"{name} on {p.device}, runner on {self.runner.device}")

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

    @staticmethod
    def from_torch_multimodal(model, tokenizer, dtype: torch.dtype = torch.float32,
                              attn_impl: str = "auto",
                              device: DeviceLike = "cuda") -> "KVPressPipeline":
        """A multimodal pipeline from a live ``Gemma3ForConditionalGeneration``:
        its text decoder and its vision tower, converted once."""
        from .models.convert import from_torch_multimodal

        params, cfg, tower = from_torch_multimodal(model, dtype=dtype, device=device)
        return KVPressPipeline(Runner.create(cfg, attn_impl=attn_impl, device=device), params,
                               tokenizer, vision_params=tower, vision_cfg=tower.vcfg,
                               image_token_id=model.config.image_token_index)

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
        pixel_values=None,           # (n_images, C, I, I) for a multimodal pipeline
    ) -> dict:
        if question is not None and questions is not None:
            raise ValueError("Either question or questions should be provided, not both.")
        if context_chunk is not None and context_bucket is not None:
            raise ValueError("context_chunk does not compose with context_bucket")
        if context_bucket is not None:
            if pixel_values is not None:
                raise ValueError("multimodal prefill does not compose with context_bucket "
                                 "(bucket pads break the image-span or-mask)")
            if press is not None and (getattr(press, "multi_pass", False)
                                      or getattr(press, "post_mask", False)):
                raise ValueError("context_bucket is not supported for multi-pass presses")
        if pixel_values is not None and self.vision_params is None:
            raise ValueError("pixel_values needs a multimodal pipeline "
                             "(KVPressPipeline.from_torch_multimodal)")
        single = questions is None
        questions = questions or ([question] if question else [""])
        if press is not None and press.compresses_decode and len(questions) > 1:
            raise ValueError("DecodingPress is not compatible with multiple questions. "
                             "Please specify a single question.")

        context_ids, question_ids = self.preprocess(
            context, questions, answer_prefix, max_context_length, enable_thinking)
        if press is not None and getattr(press, "delimiter_token_id", None) is not None \
                and hasattr(press, "with_window"):
            # FinchPress: the tokens after the delimiter are the observation
            # window; the delimiter is stripped (reference finch_press.py:
            # 123-137 does this in an embedding forward hook).
            did = press.delimiter_token_id
            if context_ids.count(did) != 1:
                raise ValueError("Exactly one delimiter token should be present.")
            pos = context_ids.index(did)
            window = len(context_ids) - 1 - pos
            if window <= 0:
                raise ValueError("No window detected (window size must be > 0).")
            context_ids = context_ids[:pos] + context_ids[pos + 1:]
            press = press.with_window(window)
        # One generator a question, seeded from the call's generator (or seed)
        # before the first question: a question's draws do not depend on the
        # answers before it.
        generators = [None] * len(question_ids)
        if do_sample:
            if generator is None:
                generator = torch.Generator().manual_seed(seed)
            generators = [
                torch.Generator(device=self.device).manual_seed(int(torch.randint(
                    0, 2 ** 62, (), generator=generator, device=generator.device)))
                for _ in question_ids]
        context_length = len(context_ids)
        if context_bucket is not None:
            # Bucketed prefill: the context padded with id 0 to a multiple of
            # the bucket; the prefill reads its first context_length tokens.
            pad_to = -(-context_length // context_bucket) * context_bucket
            context_ids = list(context_ids) + [0] * (pad_to - context_length)
        ids = torch.tensor([context_ids], dtype=torch.long, device=self.device)
        common = dict(press=press, compute_logits=True, dtype=self.params.dtype,
                      quantized=quantized, kv_bits=kv_bits)
        if pixel_values is not None:
            from .models.convert import multimodal_embeds
            from .models.siglip import encode_images

            feats = encode_images(self.vision_params, pixel_values)
            common.update(
                inputs_embeds=multimodal_embeds(self.params, self.runner.cfg, ids, feats,
                                                self.image_token_id),
                token_types=(ids == self.image_token_id).to(torch.int32),
                image_span=self.vision_cfg.mm_tokens_per_image)
            ids = None
        if context_chunk is not None:
            # Bounded activations: the context goes through in chunks of
            # context_chunk tokens, compressed once after the last one.
            prefill_logits, cache, _ = self.runner.prefill_chunked(
                self.params, ids, chunk_size=context_chunk, **common)
        else:
            prefill_logits, cache, _ = self.runner.prefill(
                self.params, ids, valid_len=None if context_bucket is None else context_length,
                **common)
        if press is not None and getattr(press, "host_compact", False):
            # Mask presses that compact (DMS compact=True): each head's kept
            # entries to the front of its buffer, each layer's length to its
            # longest head's count; the resize below then frees the rest.
            cache = compact_masked(cache)
        compressed = int(cache.length.max())
        if press is not None and getattr(press, "rerotates", False):
            # Rerotated keys sit at positions 0..n-1: the question and the
            # answer continue from the compressed length (reference
            # pipeline.py:239-241).
            cache = dataclasses.replace(cache, offset=torch.tensor(compressed, dtype=torch.int32))
        logger.debug("Context Length: %d", context_length)
        logger.debug("Compressed Context Length: %d", compressed)

        # Re-bucket the cache to realize the compression's memory saving, with
        # room for the longest question and its generation.
        kept = (press.max_kept(context_length, self.runner.cfg)
                if press is not None else context_length)
        if self.runner.cfg.sliding_window is not None:
            # Sliding layers are never compressed: they keep the whole context.
            kept = context_length
        kept = min(kept, compressed)
        max_q = max((len(q) for q in question_ids), default=0)
        cache = resize(cache, kept + max_q + max_new_tokens + 1)

        base_length, base_offset = cache.length, cache.offset
        answers = []
        for q_ids, gen in zip(question_ids, generators):
            q = torch.tensor([q_ids], dtype=torch.long, device=self.device).reshape(1, -1)
            tokens, _ = _generate_answer(
                self.runner, self.params, q, cache, prefill_logits,
                max_new_tokens=max_new_tokens, eos_ids=self._eos(),
                do_sample=do_sample, temperature=temperature, top_p=top_p,
                generator=gen,
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
