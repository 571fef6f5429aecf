"""Text-generation pipeline: compress a long context once, answer many
questions against the compressed cache (port of ``kvpress_tpu/pipeline.py``).
``batch`` serves many requests through the continuous-batching engine
(``serving.ServingEngine``).

Chat-template separator split (and FinchPress's delimiter, found and
stripped on the host), one compressing prefill (whole, padded to a multiple
of ``context_bucket`` tokens, or in chunks of ``context_chunk`` tokens), a
multi-pass press's scoring passes over the whole cache (KVzip's repeat
prompts, KVCompose's re-feed; the chunked prefill's buffer presized for
them) and the keep-mask or rebuild they give, a post-mask press's mask
(FastKVzip), the head-wise compaction of a ``host_compact`` press
(``cache.compact_masked``),
``resize`` of the cache, then per question a
question forward and greedy (or nucleus) decode with positions continuing
from the uncompressed context length (a decode-time press compressing in
the question forward and the decode steps, its state carried from the
prefill), and a rollback between questions:
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

import numpy as np
import torch

from .cache import compact_masked, grow, resize
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
    press: Optional[BasePress] = None,
    press_state=None,
) -> tuple[list[int], object]:
    """Question forward, then decode until ``max_new_tokens`` or an EOS, with
    a decode-time press (``press.compresses_decode``) and its state threaded
    through the question forward and every step. Returns (generated tokens,
    final cache). An empty question starts from the prefill's logits and
    state."""
    if press is None or not press.compresses_decode:
        press = press_state = None
    if question_ids.shape[1] > 0:
        logits, cache, press_state = runner.forward(
            params, question_ids, cache, press=press, press_state=press_state,
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
        logits, cache, press_state = runner.forward(
            params, ids, cache, press=press, press_state=press_state, logits_last_only=True,
            phase="decode")
        tok = pick(logits[0, -1])
        out.append(tok)
    return out, cache


def _chat_affixes(tok) -> tuple[int, list[int]]:
    """(prefix_len, suffix_ids) of the chat template around a user message,
    probed with a dummy separator (reference kvzip_press.py:96-117).
    Memoised on the tokenizer, keyed by its template text (a template set
    after the first call is probed anew): the presize bound and the repeat
    passes both need the affixes."""
    cached = getattr(tok, "_kvpress_chat_affixes", None)
    if cached is not None and cached[0] == tok.chat_template:
        return cached[1]
    if tok.chat_template is None:
        out = (0, tok.encode("\n", add_special_tokens=False))
    else:
        dummy = "dummy context"
        separator = "\n" + "#" * len(dummy)
        templated = tok.apply_chat_template(
            [{"role": "user", "content": dummy + separator}],
            add_generation_prompt=True, tokenize=False, enable_thinking=False,
        )
        ctx_part, suffix_text = templated.split(separator)
        prefix_len = len(tok.encode(ctx_part.split(dummy)[0], add_special_tokens=False))
        out = (prefix_len, tok.encode(suffix_text, add_special_tokens=False))
    try:
        tok._kvpress_chat_affixes = (tok.chat_template, out)
    except (AttributeError, TypeError):
        pass                              # tokenizer objects that take no attribute
    return out


def kvzip_repeat_bound(press, context_ids, tokenizer) -> int:
    """The exact room a KVzip-family press's repeat passes need after the
    context: the longest repeat prompt of this context (probed through the
    tokenizer and its chat template) plus RestoreKV's restore tokens; the
    press's static ``repeat_room()`` without a tokenizer."""
    if tokenizer is None or press.compression_ratio <= 0:
        return press.repeat_room()
    prefix_len, suffix_ids = _chat_affixes(tokenizer)
    pairs = press.chunk_pairs(list(context_ids), prefix_len, suffix_ids, tokenizer)
    room = max((len(r) for _, r in pairs), default=0)
    return room + getattr(press, "num_restore_tokens", 0)


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
        # A decode-time press rewrites the slots below the length that the
        # rollback between questions restores (the runner writes in place),
        # so it answers one question only.
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
        context_embeds = common.get("inputs_embeds")
        multi_pass = getattr(press, "multi_pass", False) if press is not None else False
        if context_chunk is not None:
            # Bounded activations: the context goes through in chunks of
            # context_chunk tokens, compressed once after the last one. A
            # multi-pass press's buffer is presized for its scoring passes
            # (growing it afterwards holds two caches at once): KVzip's exact
            # repeat room, KVCompose's whole re-fed context.
            extra = 0
            if multi_pass is True:
                extra = kvzip_repeat_bound(press, context_ids, self.tokenizer)
            elif multi_pass == "kvcompose" and press.compression_ratio > 0:
                extra = context_length
            prefill_logits, cache, press_state = self.runner.prefill_chunked(
                self.params, ids, chunk_size=context_chunk,
                max_size=context_length + extra if extra else None, **common)
        else:
            prefill_logits, cache, press_state = self.runner.prefill(
                self.params, ids, valid_len=None if context_bucket is None else context_length,
                **common)
        if press is not None and getattr(press, "rerotates", False):
            # Rerotated keys sit at positions 0..n-1: the question and the
            # answer continue from the compressed length (reference
            # pipeline.py:239-241).
            cache = dataclasses.replace(
                cache, offset=torch.tensor(int(cache.length.max()), dtype=torch.int32))
        if multi_pass == "kvcompose":
            # KVCompose: re-feed the context against its own cache, then
            # rebuild each layer to its budget or clear keep bits.
            cache = self._run_kvcompose(cache, context_ids, press, context_chunk=context_chunk,
                                        context_embeds=context_embeds)
        elif multi_pass:
            # KVzip (RestoreKV): score by reconstructing the context in repeat
            # passes over the whole cache, then clear keep bits (reference
            # kvzip_press.py __call__ / _perform_kvzip_compression).
            cache = self._run_kvzip(cache, context_ids, press, context_embeds=context_embeds)
        if press is not None and getattr(press, "post_mask", False):
            # FastKVzip: the cross-layer bottom-k over the scores it collected
            # in the prefill (reference compress_post).
            cache = press.apply_post_mask(cache, press_state)
        if press is not None and getattr(press, "host_compact", False):
            # Mask presses that compact (KVzip, FastKVzip, DMS compact=True):
            # each head's kept entries to the front of its buffer, each
            # layer's length to its longest head's count; the resize below
            # then frees the rest.
            cache = compact_masked(cache, self.runner.shard)
        compressed = int(cache.length.max())
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
                generator=gen, press=press, press_state=press_state,
            )
            answers.append(self.tokenizer.decode(tokens, skip_special_tokens=True))
            # Rollback: slots past the restored length are stale and are
            # overwritten by the next question's append.
            cache = dataclasses.replace(cache, length=base_length, offset=base_offset)
        if single:
            return {"answer": answers[0]}
        return {"answers": answers}

    @torch.no_grad()
    def batch(
        self,
        contexts: list[str],
        questions: Optional[list[Optional[str]]] = None,
        press: Optional[BasePress] = None,
        max_new_tokens: int = 50,
        answer_prefix: str = "",
        max_context_length: Optional[int] = None,
        enable_thinking: bool = False,
        n_slots: int = 8,
        capacity: Optional[int] = None,
        quantized: bool = False,
        kv_bits: int = 8,
        context_bucket: Optional[int] = None,
        context_chunk: Optional[int] = None,
        interleave: bool = False,
        question_bucket: int = 64,
        mesh=None,
        context_cache: int = 0,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        seed: int = 0,
        pixel_values: Optional[list] = None,   # per request: (n_images, C, I, I) or None
        on_token=None,       # (req_idx, token_id, n_so_far) as tokens are read
    ) -> list[str]:
        """Serve many (context, question) requests through the continuous-
        batching engine (``serving.ServingEngine``): per-request
        press-compressed prefill, one decode step over ``n_slots`` slots,
        admission as slots retire. Each answer follows the single ``__call__``
        contract (greedy, or nucleus sampling with ``do_sample``; requests
        that share a context can reuse one compressed cache through
        ``context_cache``).

        ``capacity`` (the per-slot KV budget) defaults to the longest
        context's kept bound + the bucketed longest question + the generation
        room + 1."""
        from .serving import Request, ServingEngine

        if questions is None:
            questions = [None] * len(contexts)
        if pixel_values is None:
            pixel_values = [None] * len(contexts)
        if not len(questions) == len(pixel_values) == len(contexts):
            raise ValueError("contexts, questions and pixel_values differ in length")
        image_span = None
        reqs = []
        for ctx, q, px in zip(contexts, questions, pixel_values):
            context_ids, q_ids = self.preprocess(ctx, [q] if q else [""], answer_prefix,
                                                 max_context_length, enable_thinking)
            embeds = token_types = content_key = None
            if px is not None:
                if self.vision_params is None:
                    raise ValueError("pixel_values needs a multimodal pipeline "
                                     "(KVPressPipeline.from_torch_multimodal)")
                import hashlib

                from .models.convert import multimodal_embeds
                from .models.siglip import encode_images

                ids = torch.tensor([context_ids], dtype=torch.long, device=self.device)
                embeds = multimodal_embeds(self.params, self.runner.cfg, ids,
                                           encode_images(self.vision_params, px),
                                           self.image_token_id)
                token_types = (ids == self.image_token_id).to(torch.int32)
                image_span = self.vision_cfg.mm_tokens_per_image
                # The image fingerprint: multimodal admissions share the
                # context LRU without colliding across images.
                pixels = px.cpu().numpy() if isinstance(px, torch.Tensor) else np.asarray(px)
                content_key = hashlib.sha1(np.ascontiguousarray(pixels).tobytes()).hexdigest()
            reqs.append(Request(context_ids, q_ids[0], max_new_tokens, inputs_embeds=embeds,
                                token_types=token_types, content_key=content_key))
        if capacity is None:
            longest = max(len(r.context_ids) for r in reqs)
            if context_bucket is not None:
                longest = -(-longest // context_bucket) * context_bucket
            kept = press.max_kept(longest, self.runner.cfg) if press is not None else longest
            if self.runner.cfg.sliding_window is not None:
                kept = longest        # sliding layers keep the whole context
            max_q = max(len(r.question_ids) for r in reqs)
            capacity = (kept + -(-max(max_q, 1) // question_bucket) * question_bucket
                        + max_new_tokens + 1)
        eng = ServingEngine(
            self.runner, self.params, n_slots=max(1, min(n_slots, len(reqs))),
            capacity=capacity, press=press, quantized=quantized, kv_bits=kv_bits,
            context_bucket=context_bucket, context_chunk=context_chunk, interleave=interleave,
            question_bucket=question_bucket, eos_ids=tuple(e for e in self._eos() if e >= 0),
            mesh=mesh, tokenizer=self.tokenizer, context_cache=context_cache,
            do_sample=do_sample, temperature=temperature, top_p=top_p, seed=seed,
            image_span=image_span)
        outs = eng.run(reqs, on_token=on_token)
        return [self.tokenizer.decode(list(toks), skip_special_tokens=True) for toks in outs]

    # ------------------------------------------------------------------ #
    # The multi-pass presses' scoring passes

    def _grow_for(self, cache, size: int, what: str):
        """``cache`` grown to ``size`` slots when it is smaller (the one-shot
        prefill sizes it to the context): a copy that holds two caches at
        once, so a large one warns."""
        if cache.max_size >= size:
            return cache
        logger.debug("%s grow: max_size %d -> %d", what, cache.max_size, size)
        nbytes = cache.keys.numel() * cache.keys.element_size()
        if nbytes > (1 << 30):
            logger.warning("%s grow fallback on a %.1f GiB cache (max_size %d -> %d): the grow "
                           "copy holds two full caches; presize through context_chunk",
                           what, nbytes / 2**30, cache.max_size, size)
        return grow(cache, size - cache.max_size)

    def _run_kvzip(self, cache, context_ids, press, context_embeds=None):
        """KVzip's context reconstruction (``_kvzip_scores``), then the global
        (or layerwise) bottom-k clears keep bits. RestoreKV first appends its
        restore tokens in one forward with the LoRA-merged weights, and
        evicts budget-matched (ratio + n / context length)."""
        if press.compression_ratio <= 0:
            return cache
        cache, score_val = self._kvzip_scores(cache, context_ids, press, context_embeds)
        ctx_len = len(context_ids)
        eff_press = press
        if getattr(press, "num_restore_tokens", 0) > 0:
            # RestoreKV: one LoRA-adapted pass appends the restore tokens'
            # slots; the eviction is then budget-matched (reference
            # restorekv_press.py:67-100).
            from .presses.restorekv import apply_lora

            restore_params = (apply_lora(self.params, press.lora, press.lora_scaling)
                              if press.lora else self.params)
            embeds = torch.as_tensor(press.restore_embeddings).to(
                device=self.device, dtype=self.params.dtype)[None]
            _, cache, _ = self.runner.forward(restore_params, None, cache, inputs_embeds=embeds,
                                              compute_logits=False)
            del restore_params
            overhead = press.num_restore_tokens / max(ctx_len, 1)
            eff_press = dataclasses.replace(
                press, compression_ratio=min(0.999999, press.compression_ratio + overhead))
        return self._apply_keep_mask(cache, eff_press.head_mask_from_scores(score_val))

    def _kvzip_scores(self, cache, context_ids, press, context_embeds=None):
        """KVzip's scoring passes: for each chunk, a repeat prompt attends the
        whole cache and scores the chunk's slots. Plain KVzip scores in
        ``Runner.kvzip_repeat_pass``; KVzip+ through ``Runner.forward`` with
        ``KVzipChunkScorer``, whose returned cache is dropped. Neither moves
        the context's slots, length or offset, so every pass starts from the
        same cache. The passes are queued back to back and their scores read
        once at the end. The cache is grown first when it has no room for
        the longest repeat prompt (the one-shot prefill sizes it to the
        context).

        ``context_embeds`` (1, S, E) (a multimodal context): each repeat
        prompt re-feeds its chunk's captured embeddings (vision features
        included) after the embedded repeat question. Returns (cache, scores
        (L, 1, H_kv, S) float32 numpy, the sink slots at 1)."""
        from .models.llama import embed_tokens
        from .presses.kvzip import KVzipChunkScorer

        tok = self.tokenizer
        prefix_len, suffix_ids = _chat_affixes(tok)
        pairs = press.chunk_pairs(list(context_ids), prefix_len, suffix_ids, tok)
        ctx_len = len(context_ids)
        cache = self._grow_for(cache, ctx_len + max(len(r) for _, r in pairs),
                               "KVzip repeat-pass")
        cfg = self.runner.cfg
        score_val = np.zeros((cfg.num_layers, 1, cfg.num_kv_heads, ctx_len), np.float32)
        score_val[..., :press.n_sink] = 1.0
        start, spans, score_arrs = prefix_len, [], []
        for chunk, repeat in pairs:
            end = start + len(chunk)
            rep = torch.tensor([repeat], dtype=torch.long, device=self.device)
            rep_embeds = None
            if context_embeds is not None:
                head = rep[:, :len(repeat) - len(chunk)]
                rep_embeds = torch.cat([embed_tokens(self.params, head, cfg),
                                        context_embeds[:, start:end]], dim=1)
            if not press.kvzip_plus_normalization:
                cache, sc = self.runner.kvzip_repeat_pass(self.params, rep, cache, start,
                                                          min(press.n_sink, start), end - start,
                                                          rep_embeds=rep_embeds)
            else:
                scorer = KVzipChunkScorer(start_idx=start, end_idx=end, context_length=ctx_len,
                                          n_sink=press.n_sink, plus=True)
                state = scorer.init_state(cfg, 1, ctx_len, device=self.device)
                _, _, state = self.runner.forward(
                    self.params, None if rep_embeds is not None else rep, cache, press=scorer,
                    press_state=state, phase="decode", compute_logits=False,
                    inputs_embeds=rep_embeds)
                sc = torch.stack([s["scores"] for s in state])
            score_arrs.append(sc)
            spans.append((start, end))
            start = end
        for (s0, s1), arr in zip(spans, score_arrs):
            score_val[..., s0:s1] = arr.float().cpu().numpy()
        return cache, score_val

    def _kvcompose_scores(self, cache, context_ids, press, context_chunk=None,
                          context_embeds=None):
        """KVCompose's scoring pass: the context re-fed against its own cache,
        its attention aggregated onto the context's columns. The cache is
        grown to twice the context first when it is smaller.

        With ``context_chunk`` (a context longer than one chunk) the re-feed
        runs in chunks (``Runner.kvcompose_refeed_pass``): the chunks append
        (chunk i's queries see the context and the re-fed chunks before it,
        the one-shot causality), each gives its per-head aggregation by the
        blockwise logsumexp sweep, the chunks combine by max or running sum,
        the cache is rolled back, and the group aggregation runs once at the
        end. Else one forward with ``KVComposeCollector`` over materialized
        probabilities ((B, Hq, S, 2S) float32 a layer: short contexts).
        Either way the context's slots, length and offset come back as they
        were. Returns (cache, scores (L, H_kv, S) float32 numpy)."""
        from .presses.kvcompose import KVComposeCollector

        ctx_len = len(context_ids)
        cache = self._grow_for(cache, 2 * ctx_len, "KVCompose re-feed")
        cfg = self.runner.cfg
        if context_chunk is not None and ctx_len > context_chunk:
            base_len, base_off = cache.length, cache.offset
            acc = None
            for start in range(0, ctx_len, context_chunk):
                ids_chunk = torch.tensor([context_ids[start:start + context_chunk]],
                                         dtype=torch.long, device=self.device)
                cache, part = self.runner.kvcompose_refeed_pass(
                    self.params, ids_chunk, cache, ctx_len, press.agg_task,
                    chunk_embeds=(None if context_embeds is None
                                  else context_embeds[:, start:start + context_chunk]))
                acc = part if acc is None else (
                    torch.maximum(acc, part) if press.agg_task == "max" else acc + part)
            # Rollback: the re-fed K/V sit past ctx_len, dead once the length
            # and offset are restored.
            cache = dataclasses.replace(cache, length=base_len, offset=base_off)
            acc = acc.float()                 # max partials may be bf16 (65,536+ columns)
            task = acc if press.agg_task == "max" else acc / ctx_len
            L, B, Hq = task.shape[:3]
            grouped = task.reshape(L, B, cfg.num_kv_heads, Hq // cfg.num_kv_heads, ctx_len)
            gagg = grouped.amax(dim=3) if press.agg_group == "max" else grouped.mean(dim=3)
            return cache, gagg[:, 0].cpu().numpy()
        collector = KVComposeCollector(context_len=ctx_len, agg_task=press.agg_task,
                                       agg_group=press.agg_group)
        state = collector.init_state(cfg, 1, ctx_len, device=self.device)
        ids = torch.tensor([context_ids], dtype=torch.long, device=self.device)
        _, _, state = self.runner.forward(
            self.params, None if context_embeds is not None else ids, cache, press=collector,
            press_state=state, phase="decode", compute_logits=False,
            inputs_embeds=context_embeds)
        return cache, torch.stack([s["scores"][0] for s in state]).cpu().numpy()

    @staticmethod
    def _apply_keep_mask(cache, keep: np.ndarray):
        """keep (L, B, H, ctx_len) bool, ANDed into the cache's keep-mask
        (slots past ctx_len stay as they are)."""
        L, B, H, ctx_len = keep.shape
        keep_padded = np.ones((L, B, H, cache.max_size), dtype=bool)
        keep_padded[..., :ctx_len] = keep
        keep_t = torch.from_numpy(keep_padded).to(cache.keys.device)
        return dataclasses.replace(cache, mask=keep_t if cache.mask is None
                                   else cache.mask & keep_t)

    def _run_kvcompose(self, cache, context_ids, press, context_chunk=None,
                       context_embeds=None):
        """KVCompose: the scoring pass (``_kvcompose_scores``), then
        ``_kvcompose_compress``."""
        if press.compression_ratio <= 0:
            return cache
        cache, scores = self._kvcompose_scores(cache, context_ids, press, context_chunk,
                                               context_embeds)
        return self._kvcompose_compress(cache, scores, press, len(context_ids))

    def _kvcompose_compress(self, cache, scores: np.ndarray, press, ctx_len: int):
        """The composite budgets from the scores (L, H_kv, ctx_len) (and the
        values' norms with ``add_v_norm``), then the structured per-layer
        rebuild or the unstructured keep-mask. Over a quantized cache the
        norms are those of the raw payload, as in JAX
        (``kvpress_tpu/pipeline.py:879-880``): the int8 codes, or at int4 the
        packed bytes (D/2 wide)."""
        cfg = self.runner.cfg
        values = None
        if press.add_v_norm:
            values = cache.values[:, 0, :, :ctx_len].to(torch.float32).cpu().numpy()
        budgets, keep = press.budgets_and_masks(scores, values)
        if not press.structured:
            return self._apply_keep_mask(cache, keep[:, None])

        # Structured: each layer rebuilt to its budget in place, a layer at a
        # time (the peak is one layer's gather): the kept entries gathered to
        # the front in position order (a stable sort, kept first), scales too.
        keep_buf = torch.zeros((cfg.num_layers, 1, cfg.num_kv_heads, cache.max_size),
                               dtype=torch.bool, device=self.device)
        keep_buf[..., :ctx_len] = torch.from_numpy(keep[:, None]).to(self.device)
        for l in range(cfg.num_layers):
            order = torch.argsort((~keep_buf[l]).to(torch.int8), dim=-1, stable=True)
            for buf in (cache.keys, cache.values, cache.key_scales, cache.value_scales):
                if buf is not None:
                    buf[l].copy_(torch.gather(
                        buf[l], 2, order[..., None].expand(*order.shape, buf.shape[-1])))
        return dataclasses.replace(
            cache, mask=torch.ones(keep_buf.shape, dtype=torch.bool, device=self.device),
            length=torch.tensor(budgets, dtype=torch.int32))
