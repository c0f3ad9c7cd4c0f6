"""The port's LM training path against the JAX package, on the CPU:
`forward_train`, `lm_loss` and its gradients, `make_train_step`, the
differentiable flash attention and `launch/train.py`.

Inputs are drawn once with numpy and the JAX package's own `init_params`
gives the weights, carried across with `convert.lm_params_from_numpy`;
gradients and updated parameters come back leaf by leaf with
`convert.lm_params_to_numpy`. JAX functions run jitted without a mesh,
once per arch and module (the `archs` fixture's cache).

Tolerances, with their reasons:
- logits: atol = rtol = 1e-4, aux and loss rel 1e-5 (float32 products
  summed in another order);
- gradients: each leaf within 1e-4 of its largest entry and rtol 1e-4,
  1e-8 absolute at least (the same float32 chain in another order; the
  key biases' gradients are 0 up to rounding, ~1e-10, on both sides);
- train steps (float32 compute): loss and grad norm rtol 1e-4; parameters
  after each step within 5e-5 (5 % of an Adam update of lr = 1e-3: the
  normalised update m / (sqrt(v) + eps) turns a last-bit difference of
  a gradient near eps into a visible one; most entries agree to 3e-6);
- one bf16-compute step: loss and grad norm within 2e-2 relative (bf16
  roundings that XLA fuses away and torch makes, through the whole
  forward and backward);
- the flash gradients: `ref.attention_ref` computes in float32 whatever
  the input type, so float64 inputs are held to 1e-6 of the largest
  entry when the backward recomputes in blocks (other float32 product
  shapes), and equal when it does not.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import fault  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

B, S = 2, 16
LOGIT_TOL = 1e-4
PARAM_ATOL = 5e-5
BF16_STEP_TOL = 2e-2
TRAIN_ARCHS = ("llama3p2_3b", "deepseek_v2_lite_16b")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(4, prev))
    yield
    torch.set_num_threads(prev)


class Arch:
    """One smoke arch on both sides: configs, JAX params and the port's
    copy, a numpy batch, and the JAX results computed once."""

    def __init__(self, arch):
        self.jc = jcfgs.get_config(arch, smoke=True)
        self.c = cfgs.get_config(arch, smoke=True)
        self.jp = jt.init_params(self.jc, jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.jp)
        rng = np.random.default_rng(1)
        toks = rng.integers(0, self.c.vocab_size, (B, S + 1)).astype(np.int32)
        self.batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.c.encoder_layers:
            self.batch["frames"] = (0.05 * rng.standard_normal(
                (B, self.c.encoder_frames, self.c.d_model))).astype(
                    np.float32)
        if self.c.patch_tokens:
            self.batch["patches"] = (0.05 * rng.standard_normal(
                (B, self.c.patch_tokens, self.c.d_model))).astype(np.float32)
        self._jax = {}

    def params(self):
        return convert.lm_params_from_numpy(self.c, self.np_params,
                                            device="cpu")

    def torch_batch(self):
        return {k: torch.from_numpy(v) for k, v in self.batch.items()}

    def jax_batch(self):
        return {k: jnp.asarray(v) for k, v in self.batch.items()}

    def extra(self, batch):
        return {k: batch[k] for k in ("frames", "patches") if k in batch}

    def forward(self):
        if "fwd" not in self._jax:
            b = self.jax_batch()
            fn = jax.jit(lambda p, t, kw: jt.forward_train(
                self.jc, p, t, **kw))
            logits, aux = fn(self.jp, b["tokens"], self.extra(b))
            self._jax["fwd"] = (np.asarray(logits), float(aux))
        return self._jax["fwd"]

    def value_and_grad(self):
        if "grad" not in self._jax:
            b = self.jax_batch()
            fn = jax.jit(jax.value_and_grad(
                lambda p: jsteps.lm_loss(self.jc, p, b["tokens"],
                                         b["labels"], **self.extra(b)),
                has_aux=True))
            (total, (loss, aux)), grads = fn(self.jp)
            self._jax["grad"] = (float(total), float(loss), float(aux),
                                 jax.tree.map(np.asarray, grads))
        return self._jax["grad"]


@pytest.fixture(scope="module")
def archs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Arch(arch)
        return cache[arch]
    return get


def _leaves_by_path(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _assert_trees_close(got, want, *, rel_to_max=1e-4, rtol=1e-4,
                        floor=1e-8, what=""):
    got, want = _leaves_by_path(got), _leaves_by_path(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (what, path)
        atol = rel_to_max * float(np.abs(w).max(initial=0.0)) + floor
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                   err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# forward_train and lm_loss, every arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_forward_train_matches_jax(archs, arch, remat):
    a = archs(arch)
    want_logits, want_aux = a.forward()
    tb = a.torch_batch()
    logits, aux = transformer.forward_train(a.c, a.params(), tb["tokens"],
                                            remat=remat, **a.extra(tb))
    assert logits.shape == want_logits.shape
    assert logits.shape == (B, S + a.c.patch_tokens, a.c.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert float(aux) == pytest.approx(want_aux, rel=1e-5, abs=1e-7)
    assert (float(aux) > 0) == bool(a.c.num_experts)


@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_lm_loss_and_every_gradient_match_jax(archs, arch):
    a = archs(arch)
    want_total, want_loss, want_aux, want_grads = a.value_and_grad()
    params_c = steps._compute_copy(a.params(), None)
    tb = a.torch_batch()
    total, (loss, aux) = steps.lm_loss(a.c, params_c, tb["tokens"],
                                       tb["labels"], **a.extra(tb))
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    assert float(aux.detach()) == pytest.approx(want_aux, rel=1e-5,
                                                abs=1e-7)
    assert float(total.detach()) == pytest.approx(want_total, rel=1e-5)
    leaves = steps.tree_leaves(params_c)
    grads = torch.autograd.grad(total, leaves)
    got = convert.lm_params_to_numpy(a.c,
                                     steps.tree_with_leaves(params_c, grads))
    _assert_trees_close(got, want_grads, what=f"{arch} grad")


@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_params_cross_to_numpy_and_back(archs, arch):
    a = archs(arch)
    back = convert.lm_params_to_numpy(a.c, a.params())
    _assert_trees_close(back, a.np_params, rel_to_max=0, rtol=0, floor=0,
                        what=arch)


def test_master_weights_stay_frozen(archs):
    """The compute copy takes gradients; the master tree (and so every
    serving tree) does not, and the copy aliases it in float32."""
    params = archs("llama3p2_3b").params()
    copy = steps._compute_copy(params, None)
    assert not any(p.requires_grad for p in params.parameters())
    assert all(p.requires_grad for p in copy.parameters())
    assert all(p.data_ptr() == q.data_ptr()
               for p, q in zip(params.parameters(), copy.parameters()))
    bf16 = steps._compute_copy(params, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 and p.requires_grad
               for p in bf16.parameters())


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

def _adamw(m):
    return m.chain_clip(m.adamw(m.warmup_cosine_schedule(1e-3, 1, 4)), 1.0)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_three_train_steps_match_jax(archs, arch):
    """`chain_clip(adamw(warmup_cosine_schedule))` in float32 compute: the
    metrics of each step and every parameter after it."""
    a = archs(arch)
    jo, po = _adamw(jopt), _adamw(opt)
    jstep = jax.jit(jsteps.make_train_step(a.jc, jo, compute_dtype=None))
    pstep = steps.make_train_step(a.c, po, compute_dtype=None)
    jp, js, jb = a.jp, jo.init(a.jp), a.jax_batch()
    pp = a.params()
    ps, tb = po.init(steps.tree_leaves(pp)), a.torch_batch()
    for i in range(3):
        jp, js, jm = jstep(jp, js, jb)
        pp, ps, pm = pstep(pp, ps, tb)
        for key in ("loss", "grad_norm"):
            assert float(pm[key]) == pytest.approx(float(jm[key]),
                                                   rel=1e-4), (i, key)
        assert float(pm["aux"]) == pytest.approx(float(jm["aux"]), rel=1e-4,
                                                 abs=1e-7)
        assert int(ps.step) == int(js.step) == i + 1
        _assert_trees_close(convert.lm_params_to_numpy(a.c, pp),
                            jax.tree.map(np.asarray, jp), rel_to_max=0,
                            rtol=0, floor=PARAM_ATOL, what=f"step {i}")
        assert not any(p.requires_grad for p in pp.parameters())


def test_microbatches_equal_the_full_batch(archs):
    """Gradient accumulation over 4 microbatches gives the full batch's
    loss and first update (the port of the JAX package's test, on a batch
    of 4 x 32), and equals JAX's own 4-microbatch step."""
    a = archs("llama3p2_3b")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, a.c.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    so = opt.sgd(1e-2)
    params = a.params()
    leaves0 = steps.tree_leaves(params)
    out = {}
    for m in (1, 4):
        step = steps.make_train_step(a.c, so, microbatches=m,
                                     compute_dtype=None)
        p, _, met = step(params, so.init(leaves0), tb)
        out[m] = (steps.tree_leaves(p)[0] - leaves0[0], met)
    assert float(out[1][1]["loss"]) == pytest.approx(
        float(out[4][1]["loss"]), rel=1e-4)
    np.testing.assert_allclose(out[1][0].numpy(), out[4][0].numpy(),
                               atol=5e-4, rtol=5e-2)
    jo = jopt.sgd(1e-2)
    jstep = jax.jit(jsteps.make_train_step(a.jc, jo, microbatches=4,
                                           compute_dtype=None))
    _, _, jm = jstep(a.jp, jo.init(a.jp),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert float(out[4][1][key]) == pytest.approx(float(jm[key]),
                                                      rel=1e-4)


def test_bf16_compute_step_matches_jax_bf16(archs):
    """One step in bf16 compute over float32 master weights, both sides."""
    a = archs("llama3p2_3b")
    jo, po = _adamw(jopt), _adamw(opt)
    jstep = jax.jit(jsteps.make_train_step(a.jc, jo,
                                           compute_dtype=jnp.bfloat16))
    _, _, jm = jstep(a.jp, jo.init(a.jp), a.jax_batch())
    pp = a.params()
    pstep = steps.make_train_step(a.c, po, compute_dtype=torch.bfloat16)
    new, _, pm = pstep(pp, po.init(steps.tree_leaves(pp)), a.torch_batch())
    for key in ("loss", "grad_norm"):
        assert float(pm[key]) == pytest.approx(float(jm[key]),
                                               rel=BF16_STEP_TOL), key
    assert all(p.dtype == torch.float32 for p in new.parameters())


def test_cross_pod_reduction_waits_for_item_5(archs):
    """`make_train_step(cross_pod_mesh=)` on a one-process mesh (no
    collective runs): a `data` axis alone leaves the step bit-equal to the
    plain one; a `pod` axis quantises the gradient to int8 on the way, so
    one SGD(1.0) step without clipping (update = -gradient) stays within
    `quantization_bound` of each leaf's plain gradient, and moves it."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import compression
    a = archs("llama3p2_3b")
    sgd = opt.sgd(1.0)
    params = a.params()
    leaves0 = steps.tree_leaves(params)
    out = {}
    for name, mesh in (("plain", None), ("data", make_host_mesh(("data",))),
                       ("pod", make_host_mesh(("pod", "data")))):
        step = steps.make_train_step(a.c, sgd, compute_dtype=None,
                                     clip_norm=0.0, cross_pod_mesh=mesh)
        new, _, m = step(params, sgd.init(leaves0), a.torch_batch())
        out[name] = ([x - y for x, y in zip(steps.tree_leaves(new), leaves0)],
                     float(m["loss"]))
    assert out["data"][1] == out["plain"][1] == out["pod"][1]
    assert all(torch.equal(x, y) for x, y in zip(out["data"][0],
                                                  out["plain"][0]))
    moved = False
    for q, g in zip(out["pod"][0], out["plain"][0]):
        bound = compression.quantization_bound([g]) + 1e-7
        assert float((q - g).abs().max()) <= bound
        moved = moved or not torch.equal(q, g)
    assert moved


# ---------------------------------------------------------------------------
# forward_train against the port's own prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_prefill_decode_matches_teacher_forcing(arch):
    """decode(t) logits == forward_train logits at position t (the port of
    the JAX package's test): MoE archs with a large capacity factor, so
    that no choice is dropped in either grouping; 2e-2, as there (decode
    reads the bf16 cache)."""
    c = cfgs.get_config(arch, smoke=True)
    if c.num_experts:
        c = dataclasses.replace(c, capacity_factor=8.0)
    params = transformer.init_params(c, torch.Generator().manual_seed(0),
                                     device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, c.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    kw = {}
    if c.encoder_layers:
        kw["frames"] = 0.05 * torch.randn((B, c.encoder_frames, c.d_model),
                                          generator=g)
    if c.patch_tokens:
        kw["patches"] = 0.05 * torch.randn((B, c.patch_tokens, c.d_model),
                                           generator=g)
    with torch.no_grad():
        full, _ = transformer.forward_train(c, params, tokens, remat=False,
                                            **kw)
        full = full[:, c.patch_tokens:]
        split = S // 2
        logits, state = transformer.forward_prefill(
            c, params, tokens[:, :split], max_len=S + c.patch_tokens + 4,
            **kw)
        np.testing.assert_allclose(logits[:, -1].numpy(),
                                   full[:, split - 1].numpy(), atol=2e-2,
                                   rtol=2e-2)
        got = []
        for t in range(split, S):
            ld, state = transformer.forward_decode(c, params,
                                                   tokens[:, t:t + 1], state)
            got.append(ld[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               full[:, split:].numpy(), atol=2e-2, rtol=2e-2,
                               err_msg=f"{arch} cache semantics diverge")


# ---------------------------------------------------------------------------
# The differentiable flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,hkv,sq,sk,d,dv,causal,window,q_offset", [
    (2, 4, 4, 24, 24, 16, 16, True, 0, 0),       # causal, multi-head
    (2, 8, 2, 24, 24, 16, 16, True, 0, 0),       # GQA, group 4
    (1, 4, 2, 30, 30, 8, 8, True, 7, 0),         # sliding window
    (1, 4, 1, 10, 26, 8, 8, True, 0, 16),        # past a prefix (MQA)
    (2, 4, 4, 12, 20, 16, 16, False, 0, 0),      # non-causal, Sq != Sk
    (2, 4, 4, 20, 20, 24, 16, True, 0, 0),       # D_qk != D_v (MLA-like)
    (1, 2, 2, 12, 12, 192, 128, True, 0, 0),     # MLA's (192, 128)
])
def test_flash_gradients_match_autograd_through_the_plain_version(
        b, h, hkv, sq, sk, d, dv, causal, window, q_offset):
    rng = np.random.default_rng(sq * d + h)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape))
                     for shape in ((b, h, sq, d), (b, hkv, sk, d),
                                   (b, hkv, sk, dv), (b, h, sq, dv)))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              scale=d ** -0.5)
    out = ops.flash_attention(q, k, v, **kw)
    assert out.dtype == torch.float64 and out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(ref.attention_ref(q, k, v, **kw), (q, k, v),
                               dout)
    blocked = ref.attention_backward_ref(q.detach(), k.detach(), v.detach(),
                                         dout, block_rows=5, **kw)
    for g, w, bl in zip(got, want, blocked):
        assert g.dtype == torch.float64 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=0, rtol=0)
        torch.testing.assert_close(bl, w, rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("d,dv", [(16, 16), (192, 128)])
def test_chunked_attention_gradients_match_jax(d, dv):
    """The model's attention entry (`layers.chunked_attention`) under
    autograd against `jax.grad` of the JAX one, float32, GQA 4/2."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    rng = np.random.default_rng(d)
    q = rng.standard_normal((2, 4, 24, d)).astype(np.float32)
    k = rng.standard_normal((2, 2, 24, d)).astype(np.float32)
    v = rng.standard_normal((2, 2, 24, dv)).astype(np.float32)
    w = rng.standard_normal((2, 4, 24, dv)).astype(np.float32)

    def jloss(q, k, v):
        kr, vr = (jnp.repeat(x, 2, axis=1) for x in (k, v))
        out = jlayers.chunked_attention(q, kr, vr, causal=True, chunk=8,
                                        scale=0.2)
        return jnp.sum(out * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = layers.chunked_attention(tq, tk, tv, causal=True, scale=0.2)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=2e-5,
                                   rtol=2e-5)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def test_train_main_on_the_cpu_lowers_the_loss(capsys):
    rc = train_mod.main(["--arch", "llama3p2_3b", "--smoke", "--steps", "6",
                         "--batch", "2", "--seq", "32", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    first, last = map(float, re.search(
        r"first loss ([\d.]+) -> last ([\d.]+) over 6 steps", out).groups())
    assert last < first


@pytest.mark.parametrize("arch", ["llama3p2_3b", "whisper_tiny",
                                  "internvl2_26b"])
def test_data_iterator_is_restart_safe(arch):
    c = cfgs.get_config(arch, smoke=True)
    it1 = train_mod.data_iterator(c, 2, 16, seed=3, start_step=5,
                                  device="cpu")
    it2 = train_mod.data_iterator(c, 2, 16, seed=3, device="cpu")
    for _ in range(5):
        next(it2)
    (s1, b1), (s2, b2) = next(it1), next(it2)
    assert s1 == s2 == 5 and b1.keys() == b2.keys()
    for key in b1:
        assert torch.equal(b1[key], b2[key])
    assert b1["tokens"].shape == (2, 16) and b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert ("frames" in b1) == bool(c.encoder_layers)
    assert ("patches" in b1) == bool(c.patch_tokens)
    _, b6 = next(it1)
    assert not torch.equal(b6["tokens"], b1["tokens"])


def test_train_stops_at_a_step_boundary_when_preempted():
    c = cfgs.get_config("llama3p2_3b", smoke=True)
    guard = fault.PreemptionGuard()
    guard.request()
    out = train_mod.train(c, steps_total=50, batch=2, seq=16, verbose=False,
                          guard=guard, compute_dtype=None, device="cpu")
    assert out["preempted"] and len(out["history"]) == 1
    assert np.isfinite(out["history"][0]["loss"])


@pytest.mark.parametrize("flags", [
    ["--ckpt-dir", "ckpt"], ["--restore", "none"], ["--production-mesh"],
    ["--mesh", "pod=2,data=4"], ["--compress"]])
def test_train_main_refuses_what_waits_for_item_5(flags, capsys, tmp_path,
                                                  monkeypatch):
    """The JAX driver's training-infrastructure flags on an LM arch: a
    checkpoint directory gets its step-atomic checkpoints, `--restore
    none` trains from scratch, `--mesh` and `--compress` are read by
    `--arch uleen` only (the LM driver says so and trains, as the JAX
    driver ignores them), and `--production-mesh` outside a launcher's
    256-rank world exits 2, naming the 256 ranks it needs and the world
    it found."""
    flags = [str(tmp_path / f) if prev == "--ckpt-dir" else f
             for prev, f in zip([None, *flags], flags)]
    argv = ["--arch", "llama3p2_3b", "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "8", *flags]
    if "--production-mesh" in flags:
        for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
            monkeypatch.delenv(key, raising=False)
        with pytest.raises(SystemExit) as exc:
            train_mod.main(argv)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "needs 256 ranks" in err and "a world of 1 rank" in err
        return
    assert train_mod.main(argv) == 0
    out = capsys.readouterr()
    assert "done: first loss" in out.out
    if "--ckpt-dir" in flags:
        from repro_torch.train import checkpoint
        assert checkpoint.all_steps(str(tmp_path / "ckpt")) == [2]
    if "--mesh" in flags or "--compress" in flags:
        assert "--arch uleen" in out.err


def test_train_main_refuses_the_uleen_trainer(capsys):
    """`--arch uleen` trains the paper's model in one process (the
    `--mesh` default, data=1): the multi-shot STE trainer on the smoke
    problem, printing the JAX driver's lines."""
    assert train_mod.main(["--arch", "uleen", "--device", "cpu", "--steps",
                           "2", "--batch", "64"]) == 0
    out = capsys.readouterr().out
    assert "[train] step 0" in out and "done: first loss" in out
