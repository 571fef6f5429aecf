"""Rank workers of the tensor-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_serving_parallel.py). This module imports neither JAX nor
``kvpress_tpu``: the tests compute the JAX references in their own process
and hand the ranks numpy arrays and the port's objects.

``run_world(world, jobs, tmp_path)`` starts ``world`` ranks with the
``spawn`` method (forking a process that runs JAX's threads is not safe).
The ranks meet over gloo through a ``FileStore`` under ``tmp_path``, so that
concurrent test workers never clash on a port, and each runs every job
``{label: (kind, job)}`` with one CPU thread: ``KINDS[kind](job, mesh)`` on
the mesh of ``job["mesh"]`` (meshes made in order, one per shape). Every
job gathers its result over the mesh, and rank 0 returns them. The same
functions with ``mesh=None`` are the port's single-process run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_world(world: int, jobs: dict, tmp_path, cases: str = __name__) -> dict:
    """{label: rank 0's result} of ``jobs`` on a gloo world of ``world``
    ranks; ``cases`` names the module whose ``KINDS`` and ``mesh_of`` the
    ranks use."""
    return finish_world(start_world(world, jobs, tmp_path, cases))


def start_world(world: int, jobs: dict, tmp_path, cases: str = __name__):
    """``run_world`` started and not waited for: the caller computes its
    references meanwhile, then calls ``finish_world`` on the handle."""
    d = os.path.join(str(tmp_path), f"world-{world}-{len(os.listdir(tmp_path))}")
    os.makedirs(d)
    with open(os.path.join(d, "in.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    ctx = mp.start_processes(_rank, args=(world, d, cases), nprocs=world, join=False,
                             start_method="spawn")
    return ctx, d


def finish_world(handle) -> dict:
    ctx, d = handle
    while not ctx.join():
        pass
    with open(os.path.join(d, "out.pkl"), "rb") as f:
        return pickle.load(f)


def _rank(rank: int, world: int, d: str, cases: str = __name__):
    import importlib

    torch.set_num_threads(1)
    module = importlib.import_module(cases)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), world),
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(d, "in.pkl"), "rb") as f:
            jobs = pickle.load(f)
        meshes, out = {}, {}
        for label, (kind, job) in jobs.items():
            shape = tuple(job["mesh"].items())
            if shape not in meshes:
                meshes[shape] = module.mesh_of(job["mesh"])
            out[label] = module.KINDS[kind](job, meshes[shape])
        if rank == 0:
            with open(os.path.join(d, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def mesh_of(shape: dict):
    """A mesh from {"dcn": .., "data": .., "model": ..}."""
    from kvpress_tpu_torch.parallel import make_mesh, make_mesh_hybrid

    return make_mesh_hybrid(**shape) if "dcn" in shape else make_mesh(**shape)


def as_numpy(t):
    if t is None:
        return None
    return t.numpy().copy() if t.dtype in (torch.bool, torch.uint8, torch.int8) else \
        t.detach().float().numpy()


def gathered(t, mesh, batch: bool = True):
    """A rank's shard of a cache or pool tensor gathered over ``mesh``: kv
    heads, then the batch (or slot) axis."""
    from kvpress_tpu_torch.parallel import gather_batch, gather_heads

    if t is None or mesh is None:
        return as_numpy(t)
    t = gather_heads(t, mesh)
    return as_numpy(gather_batch(t, mesh, dim=1) if batch else t)


def port_params(job: dict):
    import kvpress_tpu_torch as kt

    return kt.params_from_jax(job["params"], job["cfg"], device="cpu", dtype=torch.float32)


@contextlib.contextmanager
def sketches(job: dict):
    """The JAX package's draws, as numpy, in place of the port's own for the
    job's run: ``job["sketches"]`` ({layer: (D, 20)}) for ``CURPress``;
    ``job["leverage"]`` ({(layer, B): (B, H_kv, D, k)}, at every kv head)
    for ``LeverageScorePress`` (and Compactor's leverage child);
    ``job["uniforms"]`` ({(layer, rng_step): (B, H_kv, k)}, at every kv
    head) for ``CAMPress``. A draw of another shape than the one given
    raises."""
    from kvpress_tpu_torch.presses import cam, compactor, cur

    def given(table, key, shape):
        a = np.array(table[key], np.float32)
        if a.shape != tuple(shape):
            raise AssertionError(f"draw {key}: asked for {tuple(shape)}, given {a.shape}")
        return torch.from_numpy(a)

    patched = []
    if job.get("sketches") is not None:
        patched.append((cur.CURPress, "sketch", lambda self, ctx, d, device: torch.from_numpy(
            np.array(job["sketches"][ctx.layer_idx], np.float32)).to(device)))
    if job.get("leverage") is not None:
        patched.append((compactor.LeverageScorePress, "sketch",
                        lambda self, ctx, shape, device: given(
                            job["leverage"], (ctx.layer_idx, shape[0]),
                            (*shape, self.sketch_dimension)).to(device)))
    if job.get("uniforms") is not None:
        patched.append((cam.CAMPress, "draw_uniforms",
                        lambda self, layer, step, shape, device: given(
                            job["uniforms"], (layer, step), shape).to(device)))
    with _patched(patched):
        yield


@contextlib.contextmanager
def _patched(patched):
    """Each ``(obj, name, value)`` of ``patched`` set for the block."""
    own = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    for obj, name, value in patched:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in own:
            setattr(obj, name, value)


def own_heads_draw(draw, size: int):
    """``draw`` (a ``sketch`` or ``draw_uniforms`` method, called at every kv
    head) as a rank of a model ``size`` mesh that draws at its own heads'
    count: its rows are those a draw of that shape gives, the first
    H_kv / size of every head's draw, repeated to the whole width."""
    def drawn(self, *args):
        x = draw(self, *args)
        n = x.shape[1] // size
        return x[:, :n].repeat(1, size, *[1] * (x.dim() - 2))
    return drawn


@contextlib.contextmanager
def mutant(job: dict):
    """``job["mutant"]`` in place for the job's run: ``"random_local_draw"``
    makes ``RandomPress`` draw only the rank's own (B, H_kv local, S);
    ``"cross_head_local_decision"`` makes ``presses.base.all_heads`` (every
    module's binding of it) return the rank's own heads in place of every
    rank's (repeated to the gathered width); ``"own_heads_draw"`` makes
    ``LeverageScorePress``'s sketch and ``CAMPress``'s uniforms draws at
    the rank's own head count (``own_heads_draw``)."""
    import sys

    from kvpress_tpu_torch.presses import base, cam, compactor, random_press

    kind = job.get("mutant")
    if kind == "random_local_draw":
        patched = [(random_press.RandomPress, "score", lambda self, ctx, keys, values: torch.rand(
            keys.shape[:-1], generator=self.generator, device=keys.device, dtype=torch.float32))]
    elif kind == "cross_head_local_decision":
        def own_heads(shard, x, dim=1):
            return x if shard is None else torch.cat([x] * shard.size, dim)

        patched = [(m, "all_heads", own_heads) for n, m in list(sys.modules.items())
                   if n.startswith("kvpress_tpu_torch.")
                   and getattr(m, "all_heads", None) is base.all_heads]
    elif kind == "own_heads_draw":
        size = job["mesh"]["model"]
        patched = [(compactor.LeverageScorePress, "sketch",
                    own_heads_draw(compactor.LeverageScorePress.sketch, size)),
                   (cam.CAMPress, "draw_uniforms", own_heads_draw(cam.CAMPress.draw_uniforms,
                                                                  size))]
    else:
        patched = []
    with _patched(patched):
        yield


@contextlib.contextmanager
def recorded_scores(job: dict, press, mesh, out: dict):
    """With ``job["scores"]``, the (B, H_kv, S) scores of each layer's
    ``press.score`` call (its class's method) gathered over the mesh, as
    ``out["scores"]`` (L, B, H_kv, S); on one process also each call's
    ``(ctx, keys, values)`` as ``out["score_args"]``."""
    from kvpress_tpu_torch.parallel import gather_heads

    if not job.get("scores"):
        yield
        return
    cls, seen = type(press), []
    score = cls.score

    def recording(self, ctx, keys, values):
        got = score(self, ctx, keys, values)
        seen.append((ctx, keys.clone(), values.clone(), got))
        return got

    with _patched([(cls, "score", recording)]):
        yield
    out["scores"] = np.stack([as_numpy(s if mesh is None else gather_heads(s, mesh, dim=1))
                              for _, _, _, s in seen])
    if mesh is None:
        out["score_args"] = [a[:3] for a in seen]


# --------------------------------------------------------------------- #
# Runner jobs


def prefill(job: dict, mesh=None) -> dict:
    """The port's prefill of ``job`` (its numpy params, ids (B, S) and press;
    the runner and params sharded over ``mesh``): the last logits and the
    cache, and with ``job["decode"]`` the logits of one greedy token after
    it, all gathered over the mesh. ``job["chunk"]``: ``prefill_chunked`` in
    chunks of that size; ``job["kv_bits"]``: a quantized cache of that
    width (its K/V dequantized, and its key scales); ``job["compact"]``: ``compact_masked`` after the
    prefill; ``job["decode_steps"]``: that many greedy tokens through the
    press's decode phase (its state threaded), their logits as
    ``"steps"`` and the cache after them."""
    import kvpress_tpu_torch as kt
    from kvpress_tpu_torch.parallel import data_shard, gather_batch, shard_params

    params = port_params(job)
    runner = kt.Runner.create(job["cfg"], attn_impl=job.get("attn_impl", "xla"),
                              decode_kernel=False, device="cpu", mesh=mesh)
    ids = torch.from_numpy(np.asarray(job["ids"], np.int64))
    if mesh is not None:
        params, ids = shard_params(params, mesh), data_shard(ids, mesh)
    press = job.get("press")
    kw = dict(press=press, compute_logits=True, dtype=torch.float32)
    if job.get("kv_bits"):
        kw.update(quantized=True, kv_bits=job["kv_bits"])
    recorded = {}
    with sketches(job), mutant(job), recorded_scores(job, press, mesh, recorded):
        if job.get("chunk"):
            logits, cache, state = runner.prefill_chunked(params, ids, chunk_size=job["chunk"],
                                                          **kw)
        else:
            logits, cache, state = runner.prefill(params, ids, **kw)
    if job.get("compact"):
        cache = kt.compact_masked(cache, runner.shard)
    rows = (lambda t: t) if mesh is None else (lambda t: gather_batch(t, mesh))
    steps = []
    if job.get("decode_steps"):
        cache = kt.resize(cache, ids.shape[1] + job["decode_steps"])
        with sketches(job), mutant(job):
            for _ in range(job["decode_steps"]):
                tok = torch.argmax(logits[:, -1:], dim=-1)
                logits, cache, state = runner.forward(params, tok, cache, press=press,
                                                      press_state=state, phase="decode",
                                                      logits_last_only=True)
                steps.append(as_numpy(rows(logits)))
    out = dict(recorded, logits=as_numpy(rows(logits)), length=cache.length.numpy().copy(),
               offset=int(cache.offset))
    if steps:
        out["steps"] = np.stack(steps)
    if cache.key_scales is not None:
        out["key_scales"] = gathered(cache.key_scales, mesh)
        cache = dataclasses.replace(cache, **{n: kt.dequantize_kv(
            getattr(cache, n), getattr(cache, n[:-1] + "_scales"), cache.bits, torch.float32)
            for n in ("keys", "values")})
    for name in ("keys", "values", "mask"):
        out[name] = gathered(getattr(cache, name), mesh)
    if job.get("decode"):
        tok = torch.argmax(logits[:, -1:], dim=-1)
        step, _, _ = runner.forward(params, tok, cache, logits_last_only=True)
        out["decode"] = as_numpy(rows(step))
    return out


def duo_split(job: dict, mesh=None) -> dict:
    """DuoAttention's split-cache decode of ``job`` (its params, ids and
    Duo press; ``job["steps"]`` greedy tokens, ``job["room"]`` append
    slots): the prefill, ``build_duo_split`` of the rank's heads, then the
    steps; their tokens and logits, and every rank's (retrieval, streaming)
    buffer head counts."""
    import kvpress_tpu_torch as kt
    from kvpress_tpu_torch.parallel import shard_params

    params = port_params(job)
    runner = kt.Runner.create(job["cfg"], device="cpu", mesh=mesh)
    ids = torch.from_numpy(np.asarray(job["ids"], np.int64))
    if mesh is not None:
        params = shard_params(params, mesh)
    press = job["press"]
    logits, cache, _ = runner.prefill(params, ids, press=press, compute_logits=True,
                                      dtype=torch.float32)
    ds = kt.build_duo_split(cache, press.streaming_mask(), press.sink_size, press.recent_size,
                            job["room"], shard=runner.shard)
    heads = [(ds.retr_idx.shape[1], ds.stream_idx.shape[1])]
    if mesh is not None:
        heads = [None] * runner.shard.size
        dist.all_gather_object(heads, (ds.retr_idx.shape[1], ds.stream_idx.shape[1]),
                               group=runner.shard.group)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    toks, steps = [], []
    for _ in range(job["steps"]):
        tok, step, ds = kt.duo_decode_step(params, tok, ds, runner=runner)
        toks.append(tok.numpy().copy())
        steps.append(as_numpy(step))
    return dict(prefill=as_numpy(logits[:, -1]), tokens=np.concatenate(toks, axis=1),
                steps=np.stack(steps), heads=heads, len_r=ds.len_r.tolist(),
                offset=int(ds.offset))


def shards(job: dict, mesh) -> dict:
    """{model rank: {name: the rank's shard_params tensor as numpy}}; the
    layers' tensors named ``<layer>.<name>``."""
    from kvpress_tpu_torch.parallel import shard_params

    sp = shard_params(port_params(job) if "module" not in job else job["module"], mesh)
    mine = {f"{l}.{n}": as_numpy(p.data) for l, layer in enumerate(sp.layers)
            for n, p in layer.named_parameters(recurse=False)}
    mine.update({n: as_numpy(p.data) for n, p in sp.named_parameters(recurse=False)})
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.get_local_rank("model"), mine))
    return dict(every)


def cache_roundtrip(job: dict, mesh) -> dict:
    """``shard_cache`` of the job's cache: the local shapes, and the shards
    gathered back."""
    from kvpress_tpu_torch.parallel import shard_cache

    cache = job["cache"]
    local = shard_cache(cache, mesh)
    return dict(shape=tuple(local.keys.shape), mask_shape=tuple(local.mask.shape),
                **{n: gathered(getattr(local, n), mesh) for n in ("keys", "values", "mask")})


# --------------------------------------------------------------------- #
# Engine jobs


def serve(job: dict, mesh=None) -> dict:
    """One engine run of ``job`` (requests (context ids, question ids,
    max_new_tokens) and the engine's keywords) on the port, over ``mesh``
    when it is given: the answers, the stats that are not times, the pool
    gathered over the mesh, the slots this rank held and its local pool's
    shape."""
    import kvpress_tpu_torch as kt
    from kvpress_tpu_torch import serving

    params = port_params(job)
    runner = kt.Runner.create(job["cfg"], attn_impl="xla", decode_kernel=False, device="cpu")
    eng = serving.ServingEngine(runner, params, mesh=mesh, **job["engine"])
    reqs = [serving.Request(list(c), list(q), n) for c, q, n in job["requests"]]
    with sketches(job):
        answers = eng.run(reqs)
    sc = eng.sc
    split = eng.own.stop - eng.own.start != eng.n_slots
    pool = dict(lengths=sc.lengths.numpy().copy(), offsets=sc.offsets.numpy().copy(),
                bits=sc.bits)
    for name in ("keys", "values", "mask", "key_scales", "value_scales"):
        pool[name] = gathered(getattr(sc, name), mesh, batch=split)
    stats = {k: v for k, v in eng.last_stats.items() if not k.endswith("_s")}
    return dict(answers=answers, stats=stats, pool=pool, own=(eng.own.start, eng.own.stop),
                local_keys=tuple(sc.keys.shape))


def batch(job: dict, mesh=None) -> list:
    """``KVPressPipeline.batch(mesh=)`` on the toy tokenizer."""
    import kvpress_tpu_torch as kt
    from toy_tokenizer import ToyTokenizer

    cfg = job["cfg"]
    pipe = kt.KVPressPipeline(kt.Runner.create(cfg, device="cpu"), port_params(job),
                              ToyTokenizer(cfg.vocab_size))
    with sketches(job):
        return pipe.batch(mesh=mesh, **job["batch"])


def refused(job: dict, mesh=None) -> str:
    """The refusal of ``job["job"]`` run as ``KINDS[job["kind"]]``: its
    exception's type and message (an AssertionError if it runs)."""
    try:
        KINDS[job["kind"]](job["job"], mesh)
    except (ValueError, TypeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    raise AssertionError(f"{job['kind']} ran")


KINDS = {"prefill": prefill, "duo_split": duo_split, "shards": shards,
         "cache_roundtrip": cache_roundtrip, "serve": serve, "batch": batch, "refused": refused}
