"""The port's LM serve path against the JAX package, on the CPU.

Inputs and weights are drawn once with numpy (or by the JAX package's own
`init_params`) and carried to both sides as numpy arrays
(`repro_torch.convert.lm_params_from_numpy`). JAX step functions run
without a mesh: the JAX `Engine`'s slot prefill fails under its mesh in
this container, so the port's engine is held against JAX `serve()` and the
mesh-free step functions, never against the JAX `Engine`.

Tolerances, with their reasons:
- attention: 2e-5 in float32 (a running softmax rounds otherwise than one
  softmax), 2e-2 in bf16 (one rounding of outputs below 4) — the JAX
  package's own kernel tests use the same;
- logits: atol = rtol = 1e-4 (float32 products summed in another order);
- bf16 cache entries: one bf16 step (rtol 2^-7), since a float32 key that
  differs in its last bits can round to the neighbouring bf16 value;
- decode from the port's own state: 1e-3. Decode rounds its probabilities
  to the cache's bf16 before P·V (as JAX does), so a last-bit difference
  in a score can move one probability by a bf16 step (2^-8 relative).
  Each decode step taken from JAX's state is held at 1e-4.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_tiled  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import scheduler, serve, steps  # noqa: E402
from repro_torch.models import kvcache, layers, transformer  # noqa: E402

# the module, not the wrapper function the package re-exports
flash_mod = importlib.import_module("repro_torch.kernels.flash_attention")
MAX_LEN = 48
LOGIT_TOL = 1e-4
OWN_STATE_TOL = 1e-3
BF16_STEP = 2.0 ** -7


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,d,causal,window,dtype", [
    (64, 64, 32, True, 0, "float32"),
    (64, 64, 32, True, 16, "float32"),
    (32, 96, 16, False, 0, "float32"),
    (70, 50, 32, True, 0, "float32"),     # ragged
    (64, 64, 32, True, 0, "bfloat16"),
])
def test_plain_attention_matches_pallas_interpret_and_jax_ref(
        sq, sk, d, causal, window, dtype):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (rng.standard_normal((2, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want_tiled = flash_attention_tiled(jq, jk, jv, causal=causal,
                                       window=window, block_q=32, block_k=32,
                                       interpret=True)
    want_ref = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    # the port's interface is (B, H, S, D): the two rows become two heads
    tq, tk, tv = (_t(a).to(tdt)[None] for a in (q, k, v))
    got = kernels.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (1, 2, sq, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (want_tiled, want_ref):
        np.testing.assert_allclose(_np(got[0]), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_plain_attention_gqa_matches_jax_ops(use_kernel, causal, window):
    """H = 4 query heads over Hkv = 2: the port reads KV head h // 2 where
    the JAX dispatch repeats heads (`jnp.repeat`)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 4, 40, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 40, 16)).astype(np.float32)
            for _ in range(2))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                use_kernel=use_kernel)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_plain_attention_counts_no_launch_and_keeps_strided_inputs():
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 9, 4, 16)).astype(np.float32))
    before = kernels.flash_attention.launches
    got = kernels.flash_attention(x.transpose(1, 2), x.transpose(1, 2)[:, :2],
                                  x.transpose(1, 2)[:, :2])
    assert kernels.flash_attention.launches == before
    want = ref.attention_ref(x.transpose(1, 2).contiguous(),
                             x.transpose(1, 2)[:, :2].contiguous(),
                             x.transpose(1, 2)[:, :2].contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("sq,sk,window,q_offset,empty", [
    (8, 8, 0, 0, False), (8, 8, 3, 0, False), (8, 2, 2, 0, True),
    (9, 6, 3, 0, True), (8, 6, 3, 0, False), (8, 6, 4, 0, False), (4, 8, 2, 6, True),
    (4, 8, 2, 5, False), (4, 0, 0, 0, True)])
def test_empty_rows_rule_matches_the_mask(sq, sk, window, q_offset, empty):
    """The wrapper refuses shapes with a query row that sees no key; the
    rule agrees with the mask itself."""
    iq = q_offset + np.arange(sq)[:, None]
    ik = np.arange(sk)[None, :]
    mask = (ik <= iq) & ((ik > iq - window) if window else True)
    assert (not mask.any(axis=1).all() if sk else True) == empty
    assert flash_mod.has_empty_rows(sq, sk, window=window,
                                    q_offset=q_offset) == empty


@pytest.mark.parametrize("change,error,match", [
    ({"d": 48}, ValueError, "head dim"),
    ({"hkv": 3}, ValueError, "multiple"),
    ({"dtype": torch.float16}, TypeError, "float32 or bfloat16"),
    ({"window": 2, "sk": 2}, ValueError, "no visible key"),
    ({"q_offset": -1}, ValueError, "q_offset"),
    ({"kv_dtype": torch.bfloat16}, TypeError, "must be"),
    ({"sk_v": 5}, ValueError, "v has shape"),
    ({}, ValueError, "CUDA")])
def test_flash_wrapper_checks_what_its_kernel_reads(change, error, match):
    """The kernel reads raw pointers through strides: its wrapper refuses
    what the kernel cannot take, before any launch (meta tensors reach the
    checks and no kernel; the last case passes every check but the
    device's)."""
    c = dict(b=1, h=4, hkv=2, sq=8, sk=8, d=16, dtype=torch.float32,
             window=0, q_offset=0)
    c.update(change)
    kv_dtype = c.get("kv_dtype", c["dtype"])
    q = torch.zeros((c["b"], c["h"], c["sq"], c["d"]), dtype=c["dtype"],
                    device="meta")
    k = torch.zeros((c["b"], c["hkv"], c["sk"], c["d"]), dtype=kv_dtype,
                    device="meta")
    v = torch.zeros((c["b"], c["hkv"], c.get("sk_v", c["sk"]), c["d"]),
                    dtype=kv_dtype, device="meta")
    before = kernels.flash_attention.launches
    with pytest.raises(error, match=match):
        kernels.flash_attention(q, k, v, window=c["window"],
                                q_offset=c["q_offset"])
    assert kernels.flash_attention.launches == before


@pytest.mark.parametrize("q_offset,kv_len", [(0, None), (5, None), (3, 30)])
def test_chunked_attention_matches_jax(q_offset, kv_len):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 4, 24, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 40, 16)).astype(np.float32)
            for _ in range(2))
    want = jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=q_offset,
        kv_len=None if kv_len is None else jnp.asarray(kv_len), chunk=16)
    got = layers.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                                   q_offset=q_offset, kv_len=kv_len, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# Layers and caches
# ---------------------------------------------------------------------------

def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    s, b = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        _np(layers.rmsnorm(_t(x), _t(s))),
        _np(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        _np(layers.layernorm(_t(x), _t(s), _t(b))),
        _np(jlayers.layernorm(jnp.asarray(x), jnp.asarray(s),
                              jnp.asarray(b))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 60, (2, 7)) if per_row else np.arange(7)
           ).astype(np.int32)
    np.testing.assert_allclose(
        _np(layers.apply_rope(_t(x), _t(pos), 5e5)),
        _np(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(layers.rope_freqs(16, 5e5)),
                               _np(jlayers.rope_freqs(16, 5e5)), rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_jax(act):
    cfg = dataclasses.replace(cfgs.get_config("llama3p2_3b", smoke=True),
                              act=act)
    jc = dataclasses.replace(jcfgs.get_config("llama3p2_3b", smoke=True),
                             act=act)
    rng = np.random.default_rng(2)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": rng.standard_normal((d, f)) * 0.1,
         "w2": rng.standard_normal((f, d)) * 0.1}
    if act == "swiglu":
        p["w3"] = rng.standard_normal((d, f)) * 0.1
    else:
        p["b1"] = rng.standard_normal(f) * 0.1
        p["b2"] = rng.standard_normal(d) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    got = layers.mlp(cfg, transformer.ParamTree(
        {k: _t(v) for k, v in p.items()}), _t(x))
    want = jlayers.mlp(jc, {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 4, 1, 16)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((3, 2, 20, 16))
                        .astype(np.float32)).astype(jnp.bfloat16)
            for _ in range(2))
    kv_len = np.array([20, 1, 9], np.int32)
    want = jlayers.decode_attention(jnp.asarray(q), k, v,
                                    kv_len=jnp.asarray(kv_len))
    got = layers.decode_attention(
        _t(q), _t(_np(k)).to(torch.bfloat16), _t(_np(v)).to(torch.bfloat16),
        kv_len=_t(kv_len))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_kv_cache_writes_match_jax():
    rng = np.random.default_rng(5)
    new = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    one = rng.standard_normal((2, 2, 1, 8)).astype(np.float32)
    jc = jkv.init_attn_cache(2, 2, 6, 8)
    jc = jkv.cache_write(jc, jnp.asarray(new), jnp.asarray(new),
                         jnp.asarray([4, 5, 0]))
    jc = jkv.cache_write_at(jc, jnp.asarray(one), jnp.asarray(-one),
                            jnp.asarray([1, 3]))
    pc = kvcache.init_attn_cache(2, 2, 6, 8, device="cpu")
    out = kvcache.cache_write(pc, _t(new), _t(new), torch.tensor([4, 5, 0]))
    assert out.k.data_ptr() == pc.k.data_ptr()           # written in place
    kvcache.cache_write_at(pc, _t(one), _t(-one), torch.tensor([1, 3]))
    for got, want in zip(kvcache.cache_read(pc), jkv.cache_read(jc)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), _np(want))
    stacked = kvcache.init_attn_cache(2, 2, 6, 8, layers=3, device="cpu")
    kvcache.cache_write(stacked.layer(1), _t(new), _t(new),
                        torch.tensor([4, 5, 0]))
    assert stacked.k[1].abs().sum() > 0 and stacked.k[0].abs().sum() == 0


def test_kv_caches_default_to_the_card():
    """Without `device=` the caches go to the card, and so raise where
    there is none; asked for the CPU, they lie there."""
    cfg = cfgs.get_config("llama3p2_3b", smoke=True)
    if torch.cuda.is_available():
        assert kvcache.init_attn_cache(1, 1, 4, 8).k.is_cuda
        assert transformer.init_cache(cfg, 1, 8)[0]["l0"].k.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kvcache.init_attn_cache(1, 1, 4, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            transformer.init_cache(cfg, 1, 8)
    one = kvcache.init_attn_cache(1, 1, 4, 8, layers=2, device="cpu")
    assert one.k.device.type == one.v.device.type == "cpu"
    caches = transformer.init_cache(cfg, 2, 8, device="cpu")
    assert all(c.k.device.type == c.v.device.type == "cpu"
               for seg in caches for c in seg.values())


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantised_cache_waits_for_its_slice(dtype):
    """The quantised cache is ported (`test_torch_kvquant.py` holds it to
    JAX): int8 payloads, two int4 values a byte, float32 scales a token;
    a config with it builds its caches and params."""
    c = kvcache.init_attn_cache(1, 1, 4, 8, dtype, device="cpu")
    assert c.quant == dtype and c.k.dtype == torch.int8
    assert tuple(c.k.shape) == (1, 1, 4, 8 if dtype == "int8" else 4)
    assert tuple(c.k_scale.shape) == (1, 1, 4, 1)
    assert c.k_scale.dtype == torch.float32
    cfg = dataclasses.replace(cfgs.get_config("llama3p2_3b", smoke=True),
                              kv_cache_dtype=dtype)
    transformer.check_supported(cfg)
    caches = transformer.init_cache(cfg, 2, 8, device="cpu")
    assert caches[0]["l0"].quant == dtype


@pytest.mark.parametrize("what", ["init_paged_attn_cache",
                                  "init_paged_mla_cache", "BlockAllocator",
                                  "block_tables"])
def test_paged_structures_wait_for_their_slice(what):
    """The paged GQA and MLA pools, the allocator and paged decode are
    ported (`test_torch_paged.py` and `test_torch_mla.py` hold them to
    JAX); each pool lies on the card unless asked for the CPU."""
    cfg = cfgs.get_config("llama3p2_3b", smoke=True)
    p = transformer.init_params(cfg, torch.Generator(), device="cpu")
    if what == "init_paged_mla_cache":
        pool = kvcache.init_paged_mla_cache(8, 16, 32, 8, device="cpu")
        assert tuple(pool.ckv.shape) == (8, 16, 32)
        assert tuple(pool.krope.shape) == (8, 16, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kvcache.init_paged_mla_cache(8, 16, 32, 8)
    elif what == "init_paged_attn_cache":
        pool = kvcache.init_paged_attn_cache(2, 8, 16, 16, device="cpu")
        assert tuple(pool.k.shape) == (2, 8, 16, 16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kvcache.init_paged_attn_cache(2, 8, 16, 16)
    elif what == "BlockAllocator":
        a = kvcache.BlockAllocator(8)
        assert a.alloc(7) == list(range(1, 8)) and a.alloc(1) is None
    else:
        state = steps.paged_serve_state_zeros(cfg, p, 2, 8, block_size=4,
                                              num_blocks=3)
        logits, new = transformer.forward_decode(
            cfg, p, torch.zeros((2, 1), dtype=torch.int32), state,
            block_tables=torch.tensor([[1, 0], [2, 0]], dtype=torch.int32))
        assert tuple(logits.shape) == (2, 1, cfg.padded_vocab)
        assert new.pos.tolist() == [1, 1]


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_configs_equal_the_jax_packages(arch):
    for smoke in (False, True):
        got = dataclasses.asdict(cfgs.get_config(arch, smoke=smoke))
        want = dataclasses.asdict(jcfgs.get_config(arch, smoke=smoke))
        assert got == want
    cfg = cfgs.get_config(arch)
    assert cfg.padded_vocab == jcfgs.get_config(arch).padded_vocab
    assert cfg.param_count() == jcfgs.get_config(arch).param_count()
    assert [s.name for s in cfgs.shapes_for(cfg)] == \
        [s.name for s in jcfgs.shapes_for(jcfgs.get_config(arch))]
    assert cfgs.get_config(arch.replace("_", "-")) == cfg


def test_unported_architectures_raise_naming_the_roadmap():
    """The zoo is complete: the port's architectures are the JAX
    package's, in its order; a config outside the zoo's families is
    refused by name, as an unknown architecture is."""
    assert cfgs.ARCH_IDS == jcfgs.ARCH_IDS
    assert set(cfgs.registry()) == set(jcfgs.registry())
    with pytest.raises(ModuleNotFoundError):
        cfgs.get_config("gpt2")
    cfg = dataclasses.replace(cfgs.get_config("llama3p2_3b", smoke=True),
                              attn_kind="none")
    with pytest.raises(NotImplementedError, match="'none' attention"):
        transformer.init_params(cfg, torch.Generator(), device="cpu")


@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_init_params_follows_the_jax_schema(arch):
    cfg = cfgs.get_config(arch, smoke=True)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    jp = jt.param_shapes(jcfgs.get_config(arch, smoke=True))
    # the same top-level tree: Whisper ties its embeddings (no lm_head)
    # and adds pos_embed and the encoder
    assert set(dict(p.named_children())) | set(
        dict(p.named_parameters(recurse=False))) == set(jp)
    for name in ("embed", "lm_head", "pos_embed"):
        if name in jp:
            assert getattr(p, name).shape == jp[name].shape
    # every segment and every layer of its pattern: the JAX package stacks
    # a segment of more than one repeat on a leading axis (DeepSeek's one
    # dense layer and RecurrentGemma's tail are unstacked); so is
    # Whisper's encoder, one segment of `encoder_layers` layers
    segs = transformer.arch_segments(cfg)
    assert len(p.segments) == len(jp["segments"]) == len(segs)
    assert sum(s.repeat * len(s.layers) for s in segs) == cfg.num_layers
    pairs = list(zip(segs, p.segments, jp["segments"]))
    if cfg.encoder_layers:
        enc = transformer.Segment("encoder", (transformer.LayerSpec(
            "attn", "mlp"),), cfg.encoder_layers)
        pairs.append((enc, p.encoder.segments[0],
                      jp["encoder"]["segments"][0]))
    for sp, seg_p, seg_j in pairs:
        assert set(seg_j) == {f"l{i}" for i in range(len(sp.layers))}
        for name, jseg in seg_j.items():
            seg = getattr(seg_p, name)
            assert len(seg) == sp.repeat
            # a layer without an FFN (Mamba 2) has neither ln2 nor ffn
            assert set(dict(seg[0].named_children())) == set(jseg)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jseg):
                names = [k.key for k in path]
                t = seg[0]
                for n in names:
                    t = getattr(t, n)
                lead = (sp.repeat,) if sp.repeat > 1 else ()
                assert (*lead, *t.shape) == leaf.shape, names
    assert transformer.param_count(p) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    # the schema's distributions: zero norm gains (RMSNorm's 1 + scale;
    # a layernorm's unit gains and zero biases), 0.02 embeddings,
    # fan-in-scaled projections
    if cfg.norm == "layernorm":
        assert float((p.final_norm.scale - 1).abs().max()) == 0.0
        assert float(p.final_norm.bias.abs().max()) == 0.0
    else:
        assert float(p.final_norm.scale.abs().max()) == 0.0
    assert abs(float(p.embed.std()) - 0.02) < 0.002
    lp = p.segments[0].l0[0]
    w, fan_in = ((lp.ffn.w2, cfg.d_ff) if hasattr(lp, "ffn")
                 else (lp.mixer.out_proj, cfg.ssm_expand * cfg.d_model))
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1
    if cfg.qkv_bias:
        assert float(p.segments[0].l0[1].mixer.bq.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The model against JAX
# ---------------------------------------------------------------------------

def _with_biases(jp, seed):
    """JAX params with nonzero QKV biases (they are zeros at init)."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if path[-1].key in ("bq", "bk", "bv"):
            return jnp.asarray(
                (rng.standard_normal(x.shape) * 0.1).astype(np.float32))
        return x
    return jax.tree_util.tree_map_with_path(fill, jp)


@pytest.fixture(scope="module", params=["llama3p2_3b", "qwen2p5_14b"])
def model(request):
    arch = request.param
    jc = jcfgs.get_config(arch, smoke=True)
    cfg = cfgs.get_config(arch, smoke=True)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    if jc.qkv_bias:
        jp = _with_biases(jp, 1)
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    jprefill = jax.jit(lambda pp, t, ln: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN, length=ln))
    jprefill_full = jax.jit(lambda pp, t: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN))
    jdecode = jax.jit(lambda pp, t, s: jt.forward_decode(jc, pp, t, s))
    return dict(cfg=cfg, jc=jc, p=p, jp=jp, jprefill=jprefill,
                jprefill_full=jprefill_full, jdecode=jdecode)


def _state_to_port(jst):
    caches = [{name: kvcache.AttnCache(
        _t(_np(c.k)).to(torch.bfloat16), _t(_np(c.v)).to(torch.bfloat16))
        for name, c in seg.items()} for seg in jst.caches]
    return transformer.ServeState(caches=caches, cross=[None] * len(caches),
                                  pos=_t(np.asarray(jst.pos)))


def _assert_caches_close(pst, jst):
    for seg, jseg in zip(pst.caches, jst.caches):
        for name, c in seg.items():
            for got, want in ((c.k, jseg[name].k), (c.v, jseg[name].v)):
                assert got.dtype == torch.bfloat16
                assert got.shape == tuple(want.shape)
                np.testing.assert_allclose(_np(got), _np(want), atol=1e-6,
                                           rtol=BF16_STEP)
                # a differing entry is a rare last-bit event
                assert np.mean(_np(got) != _np(want)) < 0.01


@pytest.mark.parametrize("length_kind", ["none", "scalar", "vector"])
def test_prefill_and_teacher_forced_decode_match_jax(model, length_kind):
    m = model
    cfg, p, jp = m["cfg"], m["p"], m["jp"]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 20), dtype=np.int32)
    length = {"none": None, "scalar": 13,
              "vector": np.array([20, 7, 13], np.int32)}[length_kind]
    if length is None:
        jlog, jst = m["jprefill_full"](jp, jnp.asarray(toks))
        plen = None
    else:
        jlog, jst = m["jprefill"](jp, jnp.asarray(toks), jnp.asarray(length))
        plen = length if np.ndim(length) == 0 else _t(length)
    with torch.inference_mode():
        plog, pst = transformer.forward_prefill(
            cfg, p, _t(toks), max_len=MAX_LEN, length=plen)
    assert plog.shape == (3, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_np(plog), _np(jlog), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _assert_caches_close(pst, jst)
    np.testing.assert_array_equal(pst.pos.numpy(), np.asarray(jst.pos))
    assert pst.pos.dtype == torch.int32

    tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
    for _ in range(8):
        from_jax = _state_to_port(jst)
        jlog, jst = m["jdecode"](jp, jnp.asarray(tok), jst)
        with torch.inference_mode():
            one_step, _ = transformer.forward_decode(cfg, p, _t(tok),
                                                     from_jax)
            own, pst = transformer.forward_decode(cfg, p, _t(tok), pst)
        np.testing.assert_allclose(_np(one_step), _np(jlog), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        np.testing.assert_allclose(_np(own), _np(jlog), atol=OWN_STATE_TOL,
                                   rtol=OWN_STATE_TOL)
        np.testing.assert_array_equal(pst.pos.numpy(), np.asarray(jst.pos))
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    _assert_caches_close(pst, jst)


def test_greedy_serve_tokens_equal_jax_serve(model):
    m = model
    cfg = m["cfg"]
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 16),
                                                dtype=np.int32)
    want = np.asarray(jserve.serve(m["jc"], m["jp"], jnp.asarray(prompts),
                                   max_len=MAX_LEN, gen=10))
    got = serve.serve(cfg, m["p"], _t(prompts), max_len=MAX_LEN, gen=10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_slot_prefill_and_masked_decode_steps_match_jax(model):
    """Prefill one request into slot 2 of 4, then masked decode steps with
    slots 1 and 2 live, against JAX's mesh-free steps."""
    m = model
    cfg, jc, p, jp = m["cfg"], m["jc"], m["p"], m["jp"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (1, 16), dtype=np.int32)
    jstate = jsteps.serve_state_zeros(jc, jp, 4, MAX_LEN)
    pstate = steps.serve_state_zeros(cfg, p, 4, MAX_LEN)
    jpre = jax.jit(jsteps.make_slot_prefill_step(jc, max_len=MAX_LEN))
    jlog, jstate = jpre(jp, {"tokens": jnp.asarray(toks)}, jnp.asarray(11),
                        jnp.asarray(2), jstate)
    plog, pstate = steps.make_slot_prefill_step(cfg, max_len=MAX_LEN)(
        p, {"tokens": _t(toks)}, 11, 2, pstate)
    np.testing.assert_allclose(_np(plog), _np(jlog), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _assert_caches_close(pstate, jstate)
    np.testing.assert_array_equal(pstate.pos.numpy(), np.asarray(jstate.pos))

    jdec = jax.jit(jsteps.make_masked_decode_step(jc))
    pdec = steps.make_masked_decode_step(cfg)
    active = np.array([False, True, True, False])
    tok = rng.integers(0, cfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(3):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate, jnp.asarray(active))
        plog, pstate = pdec(p, _t(tok), pstate, _t(active))
        np.testing.assert_allclose(_np(plog), _np(jlog), atol=OWN_STATE_TOL,
                                   rtol=OWN_STATE_TOL)
        np.testing.assert_array_equal(pstate.pos.numpy(),
                                      np.asarray(jstate.pos))
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    _assert_caches_close(pstate, jstate)
    assert pstate.pos.tolist() == [0, 3, 14, 0]      # inactive pos frozen


def test_write_state_slot_rejects_a_mismatched_row():
    cfg = cfgs.get_config("llama3p2_3b", smoke=True)
    p = transformer.init_params(cfg, torch.Generator(), device="cpu")
    full = steps.serve_state_zeros(cfg, p, 4, 16)
    two = steps.serve_state_zeros(cfg, p, 2, 16)
    with pytest.raises(ValueError, match="row"):
        steps.write_state_slot(full, two, 1)


def test_cast_tree_casts_every_float_parameter():
    """A bf16 copy of float32 parameters runs the whole path in bf16."""
    cfg = cfgs.get_config("qwen2p5_14b", smoke=True)
    p = transformer.init_params(cfg, torch.Generator(), device="cpu")
    b = steps.cast_tree(p, torch.bfloat16)
    assert {t.dtype for t in b.parameters()} == {torch.bfloat16}
    assert {t.dtype for t in p.parameters()} == {torch.float32}
    assert transformer.param_count(b) == transformer.param_count(p)
    logits, state = steps.make_prefill_step(cfg, max_len=16)(
        b, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits.float()).all()
    logits, _ = steps.make_decode_step(cfg)(
        b, torch.zeros((1, 1), dtype=torch.int32), state)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits.float()).all()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    jc = jcfgs.get_config("llama3p2_3b", smoke=True)
    cfg = cfgs.get_config("llama3p2_3b", smoke=True)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    reqs = scheduler.synth_request_stream(cfg, 12, seed=4,
                                          prompt_lens=(5, 9, 16),
                                          gen_lens=(3, 6, 9))
    # JAX serve() run per request, batch 1
    want = [np.asarray(jserve.serve(jc, jp, jnp.asarray(r.tokens)[None],
                                    max_len=MAX_LEN, gen=r.max_new))[0]
            .tolist() for r in reqs]
    return dict(cfg=cfg, jc=jc, p=p, jp=jp, reqs=reqs, want=want)


def test_synth_request_stream_equals_jax():
    jc = jcfgs.get_config("llama3p2_3b", smoke=True)
    cfg = cfgs.get_config("llama3p2_3b", smoke=True)
    got = scheduler.synth_request_stream(cfg, 9, seed=3)
    want = jsched.synth_request_stream(jc, 9, seed=3)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.max_new, a.arrival) == (b.max_new, b.arrival)


@pytest.mark.parametrize("bucket", [None, "pow2"])
def test_engine_tokens_equal_jax_serve_per_request(llama, bucket):
    eng = scheduler.Engine(llama["cfg"], llama["p"], slots=4,
                           max_len=MAX_LEN, bucket=bucket, device="cpu")
    results = eng.run(llama["reqs"])
    assert [r.tokens for r in results] == llama["want"]
    st = eng.stats()
    assert st["requests"] == 12 and st["peak_active"] == 4
    assert st["tokens"] == sum(len(w) for w in llama["want"])
    assert eng.trace_counts["decode"] == 1
    widths = {r.prompt_len if bucket is None else
              scheduler._bucket_pow2(r.prompt_len) for r in llama["reqs"]}
    assert {k for k in eng.trace_counts if k.startswith("prefill_")} == \
        {f"prefill_{w}" for w in widths}


def test_engine_slot_exhaustion_queues_not_drops(llama):
    cfg = llama["cfg"]
    eng = scheduler.Engine(cfg, llama["p"], slots=2, max_len=MAX_LEN,
                           device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(5):
        eng.submit(rng.integers(0, cfg.vocab_size, 6), max_new=4)
    eng.step()
    assert len(eng.queue) == 3
    assert all(sl.state is scheduler.SlotState.DECODE for sl in eng.slots)
    results = eng.drain()
    assert len(results) == 5 and all(len(r.tokens) == 4 for r in results)
    assert eng.stats()["peak_active"] == 2


def test_engine_stats_key_set_equals_the_jax_engines(llama):
    jeng = jsched.Engine(llama["jc"], llama["jp"], slots=2, max_len=MAX_LEN)
    eng = scheduler.Engine(llama["cfg"], llama["p"], slots=2,
                           max_len=MAX_LEN, device="cpu")
    assert set(eng.stats()) == set(jeng.stats())
    assert eng.stats() == jeng.stats()          # the empty engine's values
    eng.submit(np.arange(5), max_new=3)
    eng.drain()
    st = eng.stats()
    assert set(st) == set(jeng.stats())
    assert (st["paged"], st["block_size"], st["num_blocks"],
            st["blocks_in_use"], st["peak_blocks"]) == (False, None, None,
                                                        None, None)


def test_engine_keeps_one_decode_shape_after_warm_up(llama):
    cfg = llama["cfg"]
    eng = scheduler.Engine(cfg, llama["p"], slots=3, max_len=MAX_LEN,
                           device="cpu")
    eng.submit(np.arange(8), max_new=2)
    eng.drain()
    assert eng.trace_counts["decode"] == 1
    rng = np.random.default_rng(1)
    for plen in (8, 8, 8, 8, 8):
        eng.submit(rng.integers(0, cfg.vocab_size, plen), max_new=5)
    eng.drain()
    assert eng.trace_counts["decode"] == 1
    assert eng.trace_counts["prefill_8"] == 1


def test_engine_sampled_tokens_do_not_depend_on_the_slot(llama):
    """A request's generator is seeded from (seed, rid): served alone or
    beside others, in whichever slot, it draws the same tokens."""
    cfg = llama["cfg"]
    reqs = llama["reqs"][:5]
    alone = []
    for rid, r in enumerate(reqs):
        eng = scheduler.Engine(cfg, llama["p"], slots=1, max_len=MAX_LEN,
                               greedy=False, seed=9, device="cpu")
        eng._next_rid = rid                      # the rid it has below
        eng.submit(r.tokens, r.max_new)
        alone.append(eng.drain()[0].tokens)
    eng = scheduler.Engine(cfg, llama["p"], slots=3, max_len=MAX_LEN,
                           greedy=False, seed=9, device="cpu")
    for r in reqs:
        eng.submit(r.tokens, r.max_new)
    together = [r.tokens for r in eng.drain()]
    assert together == alone
    assert all(0 <= t < cfg.padded_vocab for toks in together for t in toks)


def test_engine_rejects_what_waits_for_later_slices(llama):
    cfg, p = llama["cfg"], llama["p"]
    # the paged engine is ported (test_torch_paged.py); batched prefill
    # needs it, as in the JAX engine
    assert scheduler.Engine(cfg, p, paged=True, device="cpu").paged
    with pytest.raises(ValueError, match="paged=True"):
        scheduler.Engine(cfg, p, prefill_batch=2, device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        scheduler.Engine(cfg, p, bucket="exact", device="cpu")
    eng = scheduler.Engine(cfg, p, slots=1, max_len=12, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(10), max_new=4)
    with pytest.raises(ValueError, match="prompt_len"):
        eng.submit(np.arange(0), max_new=4)
    eng = scheduler.Engine(cfg, p, slots=1, max_len=12, bucket="pow2",
                           device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(np.arange(9), max_new=2)       # pads to 16 > 12


# ---------------------------------------------------------------------------
# The command line and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [False, True], ids=["batch", "stream"])
def test_serve_main_runs_on_the_cpu_when_asked(stream, capsys, tmp_path):
    argv = ["--arch", "llama3p2_3b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--metrics-out", str(tmp_path / "m.json")]
    if stream:
        argv += ["--stream", "--requests", "5", "--rate", "1000",
                 "--slots", "2"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert ("5 requests" in out) if stream else ("generated (2, 4)" in out)
    assert (tmp_path / "m.json").exists()


@pytest.mark.parametrize("what", ["init_params", "Engine", "serve_main"])
def test_lm_entry_points_raise_without_a_gpu(what):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    cfg = cfgs.get_config("llama3p2_3b", smoke=True)
    p = transformer.init_params(cfg, torch.Generator(), device="cpu")
    calls = {
        "init_params": lambda: transformer.init_params(
            cfg, torch.Generator(), device="cuda"),
        "Engine": lambda: scheduler.Engine(cfg, p),
        "serve_main": lambda: serve.main(["--arch", "llama3p2_3b",
                                          "--smoke"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[what]()
