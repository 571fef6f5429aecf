"""Tensor parallelism of the port (kvpress_tpu_torch/parallel/) against the
JAX package: the mirrors of tests/test_parallel.py's tensor-parallel tests
at their own tiny shapes, on gloo worlds of 8 ranks ("data" x "model" and
the hybrid "dcn" x "data" x "model" mesh) and of 2 ranks ("model" 2: int4
weights through the repacked row-parallel halves with Gemma3's post-norms,
the presses under a mesh, the shards bit-equal from either side).

Every sharded result is held against the JAX package's single-device run on
the same inputs (logits within the JAX tests' tolerance, equal lengths,
equal kept keys within KV_RTOL of their scale, equal keep-masks) and
against the port's single-process run. The ranks run
``tests/torch_parallel_cases.py`` (no JAX there); they are spawned once a
world, for every case of the file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.models.llama import quantize_params_int4 as jquant4
from kvpress_tpu.models.llama import quantize_params_int8 as jquant8
from kvpress_tpu.parallel.mesh import make_mesh as jmake_mesh
from kvpress_tpu.parallel.mesh import param_shardings
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.models.llama import quantize_params_int4 as tquant4
from kvpress_tpu_torch.models.llama import quantize_params_int8 as tquant8
from kvpress_tpu_torch.parallel import MESH_ITEMS, check_press, repack_int4_rows
from torch_parallel_cases import prefill, run_world

torch.set_num_threads(2)

LOGIT_TOL = dict(atol=2e-4, rtol=1e-3)       # tests/test_parallel.py's
KV_RTOL = 1e-5                                # live K/V, float32 on both sides

# (label, JAX press, port press) held under "model" 2.
PRESSES = {
    "knorm": (kj.KnormPress(0.5), kt.KnormPress(0.5)),
    "snapkv": (kj.SnapKVPress(0.5, window_size=8), kt.SnapKVPress(0.5, window_size=8)),
    "pyramidkv": (kj.PyramidKVPress(0.5, window_size=8), kt.PyramidKVPress(0.5, window_size=8)),
    "observed": (kj.ObservedAttentionPress(0.5), kt.ObservedAttentionPress(0.5)),
    "adakv_compact": (kj.AdaKVPress(kj.KnormPress(0.5), compact=True),
                      kt.AdaKVPress(kt.KnormPress(0.5), compact=True)),
    "adakv_mask": (kj.AdaKVPress(kj.SnapKVPress(0.5, window_size=8)),
                   kt.AdaKVPress(kt.SnapKVPress(0.5, window_size=8))),
    "expected": (kj.ExpectedAttentionPress(0.5, n_future_positions=16),
                 kt.ExpectedAttentionPress(0.5, n_future_positions=16)),
    "streaming": (kj.StreamingLLMPress(0.5), kt.StreamingLLMPress(0.5)),
    "keydiff": (kj.KeyDiffPress(0.5), kt.KeyDiffPress(0.5)),
    "lagkv": (kj.LagKVPress(0.5, lag_size=8), kt.LagKVPress(0.5, lag_size=8)),
}
# Gemma3's layer body at a tiny size: q/k-norms, (1 + w) norms, the
# post-norms after attention and after the MLP, gelu, a logit softcap, a
# tied head; the 2-rank world's model.
GEMMA_LIKE = dict(num_heads=4, num_kv_heads=2, qk_norm=True, post_norms=True,
                  rms_one_offset=True, act="gelu_tanh", logit_softcap=30.0,
                  scale_embeddings=True, tie_word_embeddings=True)


def numpy_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def jax_prefill(cfg, params, ids, press=None, decode=False):
    runner = kj.Runner.create(cfg, attn_impl="xla")
    logits, cache, _ = runner.prefill(params, jnp.asarray(ids), press=press, dtype=jnp.float32,
                                      compute_logits=True)
    out = dict(logits=np.asarray(logits), length=np.asarray(cache.length),
               keys=np.asarray(cache.keys), values=np.asarray(cache.values),
               mask=None if cache.mask is None else np.asarray(cache.mask))
    if decode:
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        step, _, _ = runner.forward(params, tok, cache, logits_last_only=True)
        out["decode"] = np.asarray(step)
    return out


def assert_same_rows(a: np.ndarray, b: np.ndarray, tol: float, what):
    """Each (batch, head)'s rows of ``a`` (B, H, n, C) and of ``b`` are one
    set within ``tol``: every row of either has a row of the other that
    close. The order of equal scores (a repeated token's keys, whose norms
    differ only in rounding) is not part of the kept set, and a sum over
    ranks rounds otherwise than one device."""
    dist = np.abs(a[:, :, :, None] - b[:, :, None]).max(-1)           # (B, H, n, n)
    assert dist.min(-1).max() <= tol and dist.min(-2).max() <= tol, what


def assert_same_prefill(got, want, logit_tol=LOGIT_TOL):
    """Logits within the tolerance, equal lengths, the kept (key, value)
    rows within KV_RTOL of their scale (as sets: ``assert_same_rows``, but
    in place under a keep-mask) and equal keep bits below each length."""
    np.testing.assert_allclose(got["logits"], want["logits"], **logit_tol)
    if "decode" in want:
        np.testing.assert_allclose(got["decode"], want["decode"], **logit_tol)
    np.testing.assert_array_equal(got["length"], want["length"])
    for l, n in enumerate(want["length"].tolist()):
        a, b = (np.concatenate([c[k][l, :, :, :n] for k in ("keys", "values")], -1)
                for c in (got, want))
        tol = KV_RTOL * max(np.abs(b).max(), 1e-6)
        if want.get("mask") is None or want["mask"][l, :, :, :n].all():
            assert_same_rows(a, b, tol, l)
        else:
            # Keep bits are positional: the rows must sit where JAX's do.
            assert np.abs(a - b).max() <= tol, l
            np.testing.assert_array_equal(got["mask"][l, :, :, :n], want["mask"][l, :, :, :n])


# --------------------------------------------------------------------- #
# The 8-rank world


def _tp_model():
    cfg_j = kj.tiny_config(num_heads=8, num_kv_heads=4, intermediate_size=256)
    cfg_t = kt.tiny_config(num_heads=8, num_kv_heads=4, intermediate_size=256)
    return cfg_j, cfg_t, kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """The cases of the 8-rank world, with their JAX references."""
    cfg_j, cfg_t, params = _tp_model()
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, cfg_j.vocab_size))
    knorm = (kj.KnormPress(0.5), kt.KnormPress(0.5))

    cfg8_j = kj.tiny_config(num_heads=8, num_kv_heads=4, intermediate_size=256,
                            tie_word_embeddings=False)
    cfg8_t = kt.tiny_config(num_heads=8, num_kv_heads=4, intermediate_size=256,
                            tie_word_embeddings=False)
    q8 = jquant8(kj.init_params(cfg8_j, jax.random.PRNGKey(0), dtype=jnp.float32),
                 include_embeddings=True)

    cfgh_j = kj.tiny_config(num_heads=4, num_kv_heads=2, intermediate_size=128)
    cfgh_t = kt.tiny_config(num_heads=4, num_kv_heads=2, intermediate_size=128)
    ph = kj.init_params(cfgh_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    idsh = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, cfgh_j.vocab_size))

    tp = {"data": 2, "model": 4}
    jobs = {
        "forward": dict(cfg=cfg_t, params=numpy_tree(params), ids=ids, press=knorm[1], mesh=tp),
        "int8": dict(cfg=cfg8_t, params=numpy_tree(q8), ids=ids, mesh=tp),
        "hybrid": dict(cfg=cfgh_t, params=numpy_tree(ph), ids=idsh, press=knorm[1], decode=True,
                       mesh={"dcn": 2, "data": 2, "model": 2}),
    }
    single = {k: prefill(dict(job, mesh=None)) for k, job in jobs.items()}
    _, cache, _ = kt.Runner.create(cfg_t, device="cpu").prefill(
        kt.params_from_jax(numpy_tree(params), cfg_t, device="cpu", dtype=torch.float32),
        torch.from_numpy(ids.astype(np.int64)), press=knorm[1], dtype=torch.float32)
    cache = kt.KVCache(**{**cache.__dict__, "mask": torch.rand(cache.keys.shape[:4],
                                                             generator=torch.Generator()
                                                             .manual_seed(0)) > 0.3})
    sharded = run_world(8, {**{k: ("prefill", j) for k, j in jobs.items()},
                            "roundtrip": ("cache_roundtrip", dict(cache=cache, mesh=tp))},
                        tmp_path_factory.mktemp("eight"))
    want = dict(forward=jax_prefill(cfg_j, params, ids, knorm[0]),
                int8=jax_prefill(cfg8_j, q8, ids),
                hybrid=jax_prefill(cfgh_j, ph, idsh, knorm[0], decode=True))
    return dict(sharded=sharded, single=single, want=want, cache=cache,
                q8_logits_close=np.abs(jax_prefill(
                    cfg8_j, kj.init_params(cfg8_j, jax.random.PRNGKey(0), dtype=jnp.float32),
                    ids)["logits"] - want["int8"]["logits"]).max()
                / np.abs(want["int8"]["logits"]).max())


def test_tensor_parallel_forward_matches_single_device(eight):
    """data 2 x model 4, Knorm 0.5: the logits, the lengths (16) and the kept
    K/V of the sharded prefill equal the single-device run's, JAX's and the
    port's."""
    got = eight["sharded"]["forward"]
    assert_same_prefill(got, eight["want"]["forward"])
    assert_same_prefill(got, eight["single"]["forward"])
    assert got["length"].tolist() == [16, 16]


def test_tensor_parallel_int8_embeddings(eight):
    """int8 layers, embedding (per-row scales, replicated) and head (its
    scale cut with the vocabulary) over data 2 x model 4: the logits equal
    the single-device int8 run's, and that run stays near the float one."""
    assert eight["q8_logits_close"] < 0.05
    assert_same_prefill(eight["sharded"]["int8"], eight["want"]["int8"])
    assert_same_prefill(eight["sharded"]["int8"], eight["single"]["int8"])


def test_cache_sharding_roundtrip(eight):
    """shard_cache gives (L, B/dp, Hkv/tp, S, D) and the shards gathered back
    are the cache, keep-mask included."""
    got, cache = eight["sharded"]["roundtrip"], eight["cache"]
    L, B, H, S, D = cache.keys.shape
    assert got["shape"] == (L, B // 2, H // 4, S, D)
    assert got["mask_shape"] == (L, B // 2, H // 4, S)
    for name in ("keys", "values", "mask"):
        np.testing.assert_array_equal(got[name], getattr(cache, name).numpy())


def test_hybrid_dcn_mesh_matches_single_device(eight):
    """dcn 2 x data 2 x model 2: prefill, Knorm and one decode token equal
    the single-device run."""
    assert_same_prefill(eight["sharded"]["hybrid"], eight["want"]["hybrid"])
    assert_same_prefill(eight["sharded"]["hybrid"], eight["single"]["hybrid"])


# --------------------------------------------------------------------- #
# The 2-rank world: "model" 2


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    cfg_j, cfg_t = kj.tiny_config(**GEMMA_LIKE), kt.tiny_config(**GEMMA_LIKE)
    params = kj.init_params(cfg_j, jax.random.PRNGKey(2), dtype=jnp.float32)
    # Spread the norm weights (at their init value every key has one norm).
    rng = np.random.default_rng(5)
    layers = dict(params["layers"])
    for name in ("ln1", "ln2", "ln1_post", "ln2_post", "q_norm", "k_norm"):
        layers[name] = jnp.asarray(rng.normal(0, 0.3, layers[name].shape).astype(np.float32))
    params = dict(params, layers=layers)
    p4 = jquant4(params)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (1, 48), 0, cfg_j.vocab_size))
    mesh = {"data": 1, "model": 2}
    jobs = {f"press-{k}": ("prefill", dict(cfg=cfg_t, params=numpy_tree(params), ids=ids,
                                            press=tp, mesh=mesh))
            for k, (_, tp) in PRESSES.items()}
    jobs["int4"] = ("prefill", dict(cfg=cfg_t, params=numpy_tree(p4), ids=ids,
                                    press=kt.KnormPress(0.5), decode=True, mesh=mesh))
    # The shards: from the JAX tree quantized by JAX, and from the port's
    # module quantized by the port.
    base = kt.params_from_jax(numpy_tree(params), cfg_t, device="cpu", dtype=torch.float32)
    for kind, jq, tq in (("int8", lambda p: jquant8(p, include_embeddings=True),
                          lambda m: tquant8(m, include_embeddings=True)),
                         ("int4", jquant4, tquant4)):
        jobs[f"shards-{kind}-jax"] = ("shards", dict(cfg=cfg_t, params=numpy_tree(jq(params)),
                                                     mesh=mesh))
        jobs[f"shards-{kind}-port"] = ("shards", dict(module=tq(base), mesh=mesh))
    jobs["shards-bf16-port"] = ("shards", dict(module=kt.params_from_jax(
        numpy_tree(params), cfg_t, device="cpu", dtype=torch.bfloat16), mesh=mesh))
    sharded = run_world(2, jobs, tmp_path_factory.mktemp("two"))
    return dict(cfg=(cfg_j, cfg_t), params=params, p4=p4, ids=ids, sharded=sharded)


@pytest.mark.parametrize("label", list(PRESSES))
def test_presses_keep_jax_sets_under_a_mesh(two, label):
    """Each press that runs under a mesh keeps, on model 2, JAX's kept sets
    (keys, values, lengths, keep bits) and logits, and the port's
    single-process ones: shard-local scorers, AdaKV's decision across every
    rank's heads (mask and compact), the pinned windows and sinks."""
    (cfg_j, cfg_t), params, ids = two["cfg"], two["params"], two["ids"]
    jp, tp = PRESSES[label]
    got = two["sharded"][f"press-{label}"]
    assert_same_prefill(got, jax_prefill(cfg_j, params, ids, jp))
    assert_same_prefill(got, prefill(dict(cfg=cfg_t, params=numpy_tree(params), ids=ids,
                                          press=tp)))


def test_int4_weights_repacked_row_shards_with_post_norms(two):
    """int4 weights on model 2 with Gemma3's post-norms: rank 0's rows of
    wo and wd are all low nibbles, rank 1's all high; the repacked halves
    give the single-device logits (prefill and a decode token) and kept
    sets."""
    (cfg_j, cfg_t), p4, ids = two["cfg"], two["p4"], two["ids"]
    got = two["sharded"]["int4"]
    assert_same_prefill(got, jax_prefill(cfg_j, p4, ids, kj.KnormPress(0.5), decode=True))
    assert_same_prefill(got, prefill(dict(cfg=cfg_t, params=numpy_tree(p4), ids=ids,
                                          press=kt.KnormPress(0.5), decode=True)))


def _jax_device_shards(params, n_model: int) -> dict:
    """{model rank: {name: the device's block}} of JAX's param_shardings on a
    data 1 x model n mesh, the layers as ``<layer>.<name>``."""
    mesh = jmake_mesh(data=1, model=n_model)
    placed = jax.device_put(params, param_shardings(mesh, params))
    out = {r: {} for r in range(n_model)}
    flat = {f"layers.{k}": v for k, v in placed["layers"].items()}
    flat.update({k: v for k, v in placed.items() if k != "layers"})
    for name, arr in flat.items():
        for s in arr.addressable_shards:
            r = int(np.argwhere(mesh.devices == s.device)[0][1])
            data = np.asarray(s.data, np.float32) if arr.dtype == jnp.bfloat16 else \
                np.asarray(s.data)
            if name.startswith("layers."):
                for l in range(data.shape[0]):
                    out[r][f"{l}.{name[7:]}"] = data[l]
            else:
                out[r][name] = data
    return out


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_shards_from_the_jax_tree_are_bit_equal(two, kind):
    """shard_params of the JAX tree (quantized by JAX, carried by
    params_from_jax) equals shard_params of the port's module (quantized by
    the port), bit for bit, on both ranks; for bf16 and int8 both also equal
    JAX's own device blocks under param_shardings (the embedding, which the
    port replicates, aside); an int4 row-parallel block is the global codes'
    rows repacked."""
    params = two["params"]
    port = two["sharded"][f"shards-{kind}-port"]
    if kind != "bf16":
        from_jax = two["sharded"][f"shards-{kind}-jax"]
        for r in (0, 1):
            assert from_jax[r].keys() == port[r].keys()
            for name in port[r]:
                np.testing.assert_array_equal(from_jax[r][name], port[r][name], err_msg=name)
    tree = {"bf16": jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params),
            "int8": jquant8(params, include_embeddings=True), "int4": jquant4(params)}[kind]
    blocks = _jax_device_shards(tree, 2)
    for r in (0, 1):
        for name, want in blocks[r].items():
            row_int4 = kind == "int4" and name.split(".")[-1] in ("wo", "wd", "wo_scale",
                                                                  "wd_scale")
            if name == "embed" or row_int4:
                continue
            np.testing.assert_array_equal(port[r][name], want, err_msg=f"{kind} {r} {name}")
        if kind == "int4":
            for l in range(len(params["layers"]["wo"])):
                for w in ("wo", "wd"):
                    glob = np.asarray(tree["layers"][w][l])
                    codes = np.concatenate([glob & 0xF, glob >> 4])
                    n = codes.shape[0] // 2
                    mine = port[r][f"{l}.{w}"]
                    np.testing.assert_array_equal(
                        np.concatenate([mine & 0xF, mine >> 4]), codes[r * n:(r + 1) * n])
                    scale = np.asarray(tree["layers"][w + "_scale"][l])
                    np.testing.assert_array_equal(port[r][f"{l}.{w}_scale"],
                                                  np.stack([scale[r], scale[r]]))


def test_repack_int4_rows_keeps_the_single_device_product():
    """At model 2 and 4, the sum over ranks of each rank's product with its
    repacked int4 block equals the single-device int4 product; a block whose
    halves take the other global half's scale does not."""
    from kvpress_tpu_torch.models.llama import _lin, quantize_layer_int4

    g = torch.Generator().manual_seed(0)
    w = torch.randn(32, 12, generator=g)
    layer = quantize_layer_int4({n: w.clone() for n in ("wq", "wk", "wv", "wo", "wg", "wu",
                                                       "wd")})
    h = torch.randn(3, 32, generator=g)
    want = _lin(h, layer, "wo")
    for size in (2, 4):
        n = 32 // size
        got = sum(_lin(h[:, r * n:(r + 1) * n], dict(zip(("wo", "wo_scale"), repack_int4_rows(
            layer["wo"], layer["wo_scale"], r, size))), "wo") for r in range(size))
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # The mutant: each rank's halves take the other global half's scale.
    swapped = sum(_lin(h[:, r * 16:(r + 1) * 16], {
        "wo": repack_int4_rows(layer["wo"], layer["wo_scale"], r, 2)[0],
        "wo_scale": layer["wo_scale"][1 - r].expand(2, -1)}, "wo") for r in range(2))
    assert not torch.allclose(swapped, want, atol=1e-3)


@pytest.mark.parametrize("press", [kt.KVzipPress(0.5), kt.KVComposePress(compression_ratio=0.5),
                                   kt.FastKVzipPress(0.5)],
                         ids=["kvzip", "kvcompose", "fastkvzip"])
def test_presses_of_later_items_are_refused_under_a_mesh(press):
    """A press of class (b) or (c) that is not ported to a mesh raises
    NotImplementedError naming its ROADMAP item (a wrapper: its own)."""
    name = type(press).__name__
    with pytest.raises(NotImplementedError, match=f"item {MESH_ITEMS[name]} "):
        check_press(press)


def test_every_exported_press_is_classified_for_a_mesh():
    """Each press class the package exports either runs under a mesh or has
    its ROADMAP item (Queue A item 18)."""
    import kvpress_tpu_torch.presses as presses

    names = {n for n in presses.__all__ if n.endswith(("Press", "Collector", "Scorer"))
             and n not in ("ScorerPress", "BasePress")}
    from kvpress_tpu_torch.parallel import MESH_PRESSES

    assert names == (set(MESH_PRESSES) - {"BasePress"}) | set(MESH_ITEMS)
    assert not set(MESH_PRESSES) & set(MESH_ITEMS)
    assert len(names) == 44
