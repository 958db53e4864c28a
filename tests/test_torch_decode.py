"""The backbone's decode path in the port against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX
``LM`` (jitted once a variant, in module-scoped fixtures) and the
port's, with the JAX weights carried across by
``bridge.lm_state_from_numpy`` (the norm weights, zeros at init, get
noise first so that ``qk_norm`` and every norm do something).  The
variants are the reduced tinyllama (2 layers, d 128, 4/2 heads of 32)
and its ``qk_norm``, local/global (``"LLG"`` over 4 layers, window 8:
a tail segment of one local layer), tied-embedding, ``vocab=500`` (a
padded vocab), enc-dec (2 encoder layers, ``prefix_len`` 4, a ``src``)
and vlm (a 4-embedding ``prefix``) forms.

* ``decode_attention`` and ``cache_update``, the clamp of a write past
  the cache's end included (the reference's ``dynamic_update_slice``
  writes the last entry).
* ``prefill``: the logits and every cache leaf; ``decode_step`` from
  the port's own prefill and from the JAX prefill's caches
  (``bridge.lm_caches_from_numpy``): every step's logits and the final
  caches; a decode at ``pos = S`` and ``S + 3`` into prefill's caches.
* ``train_loss`` and ``chunked_lm_loss``: masked targets, chunks
  smaller than L with a ragged last chunk, all targets masked.
* ``init_cache``, ``cache_shapes`` and ``param_shapes`` shapes and
  logical axes; ``make_rules`` / ``logical_to_spec``.

Logits, caches and losses agree within 1e-4 of the largest magnitude
(``_close_rel``: fp32 sums in another order through every layer); the
padded vocab's logits are -1e30 in both.  The ``cuda``-marked tests hold
the kernel run's prefill against the plain attention's on the card.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import sharding as jsharding
from repro.models import attention as jattn
from repro.models import get_model as jget_model
from repro.models import layers as jlayers
from repro.models.registry import chunked_lm_loss as jchunked_lm_loss
from repro_torch.bridge import (_layer_index, lm_caches_from_numpy,
                                lm_caches_to_numpy, lm_state_from_numpy)
from repro_torch.distributed import logical_to_spec, make_mesh, make_rules
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, get_model
from repro_torch.models.registry import chunked_lm_loss

TOL = 1e-4
B, L, STEPS = 2, 12, 4
VARIANTS = {
    "dense": ({}, None),
    "qk_norm": (dict(qk_norm=True), None),
    "local-global": (dict(local_global_pattern="LLG", n_layers=4,
                          sliding_window=8), None),
    "tie": (dict(tie_embeddings=True), None),
    "vocab500": (dict(vocab=500), None),
    "encdec": (dict(family="encdec", encoder_layers=2, prefix_len=4), "src"),
    "vlm": (dict(family="vlm", prefix_len=4), "prefix"),
}
NORMS = ("ln1", "ln2", "ln_x", "ln_f", "q_norm", "k_norm")


def _close_rel(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _close_logits(got, want, vocab):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    _close_rel(got[:, :vocab], want[:, :vocab])
    assert (got[:, vocab:] == -1e30).all() and (want[:, vocab:] == -1e30).all()


def _close_tree(got, want):
    """Two JAX-layout cache trees, leaf by leaf."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for i in w:
            assert g[i].keys() == w[i].keys(), (g[i].keys(), w[i].keys())
            for name in w[i]:
                _close_rel(g[i][name], w[i][name])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_norms(tree, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if str(path[-1].key) in NORMS:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


def _grow_np(small, big):
    out = []
    for s, b in zip(small, big):
        seg = {}
        for i in b:
            seg[i] = {}
            for name, a in b[i].items():
                a = np.array(a)
                src = np.asarray(s[i][name])
                a[:, :, :, :src.shape[3]] = src
                seg[i][name] = a
        out.append(seg)
    return out


def _batch(name, cfg, seed=0, length=L):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, length)).astype(
        np.int32)}
    extra = VARIANTS[name][1]
    if extra is not None:
        batch[extra] = (0.5 * rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    targets = rng.integers(0, cfg.vocab, (B, length)).astype(np.int32)
    targets[0, ::3] = -1                       # masked positions
    batch["targets"] = targets
    return batch


class Case:
    """One variant: the JAX model's results, and a port model holding
    the same weights."""


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request):
    name = request.param
    over = VARIANTS[name][0]
    jm = jget_model("tinyllama-1.1b", reduced=True, remat="none", **over)
    tree = _perturb_norms(jlayers.values(jm.init(jax.random.key(3))), 4)
    c = Case()
    c.name, c.cfg = name, jm.cfg
    c.batch = _batch(name, jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in c.batch.items()}
    prefill = jax.jit(jm.prefill)
    decode = jax.jit(jm.decode_step)
    c.logits, caches = prefill(tree, jb)
    c.logits, c.caches = np.asarray(c.logits), _np_tree(caches)
    c.loss = float(jax.jit(jm.train_loss)(tree, jb)[0])
    # Ltot positions went in (the prefix included); decode STEPS more
    # into caches grown to S = Ltot + STEPS
    c.ltot = L + (jm.cfg.prefix_len if "prefix" in c.batch else 0)
    c.S = c.ltot + STEPS
    c.steps = np.random.default_rng(5).integers(
        0, jm.cfg.vocab, (STEPS, B)).astype(np.int32)
    c.grown = _grow_np(c.caches, _np_tree(jlayers.values(
        jm.init_cache(B, c.S))))
    cur, c.step_logits = c.grown, []
    for t in range(STEPS):
        lg, cur = decode(tree, cur, jnp.asarray(c.steps[t]),
                         jnp.asarray(c.ltot + t, jnp.int32))
        c.step_logits.append(np.asarray(lg))
    c.final = _np_tree(cur)
    # past the end of prefill's own caches: the write clamps to S - 1
    c.clamped = []
    for pos in (c.ltot, c.ltot + 3):
        lg, cc = decode(tree, c.caches, jnp.asarray(c.steps[0]),
                        jnp.asarray(pos, jnp.int32))
        c.clamped.append((pos, np.asarray(lg), _np_tree(cc)))
    c.jm, c.tree = jm, tree
    c.np_tree = _np_tree(tree)
    c.tm = get_model("tinyllama-1.1b", reduced=True, device="cpu", **over)
    c.tm.load_state_dict(lm_state_from_numpy(c.np_tree, c.tm))
    return c


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_prefill_matches_jax(case):
    with torch.inference_mode():
        logits, caches = case.tm.prefill(_port_batch(case.batch))
    _close_logits(logits.numpy(), case.logits, case.cfg.vocab)
    _close_tree(lm_caches_to_numpy(caches, case.tm), case.caches)


def test_decode_step_matches_jax(case):
    """Prefill, grow, then every step's logits and the final caches; the
    position alternates between an int and a 0-d tensor."""
    tm = case.tm
    with torch.inference_mode():
        _, caches = tm.prefill(_port_batch(case.batch))
        caches = tm.grow_caches(caches, case.S)
        for t in range(STEPS):
            pos = case.ltot + t
            out, same = tm.decode_step(caches, torch.from_numpy(case.steps[t]),
                                       pos if t % 2 else torch.tensor(pos))
            assert same is caches                  # updated in place
            _close_logits(out.numpy(), case.step_logits[t], case.cfg.vocab)
    _close_tree(lm_caches_to_numpy(caches, tm), case.final)


def test_decode_from_jax_caches(case):
    """The JAX prefill's caches, carried across, decoded by the port; the
    bridge's round trip is exact."""
    tm = case.tm
    caches = lm_caches_from_numpy(case.grown, tm)
    back = lm_caches_to_numpy(caches, tm)
    for g, w in zip(back, case.grown):
        for i in w:
            for name in w[i]:
                np.testing.assert_array_equal(g[i][name], w[i][name])
    with torch.inference_mode():
        for t in range(STEPS):
            out, _ = tm.decode_step(caches, case.steps[t], case.ltot + t)
            _close_logits(out.numpy(), case.step_logits[t], case.cfg.vocab)
    _close_tree(lm_caches_to_numpy(caches, tm), case.final)


@pytest.mark.parametrize("past", [0, 3], ids=["pos=S", "pos=S+3"])
def test_decode_past_the_cache_end_clamps(case, past):
    """A decode at ``pos >= S`` into prefill's own caches (S = the input's
    length; a local layer's min(S, w)) overwrites the last entry as the
    reference's clamped ``dynamic_update_slice`` does, and raises
    nothing."""
    pos, want_logits, want = case.clamped[past // 3]
    caches = lm_caches_from_numpy(case.caches, case.tm)
    with torch.inference_mode():
        out, caches = case.tm.decode_step(caches, case.steps[0], pos)
    _close_logits(out.numpy(), want_logits, case.cfg.vocab)
    _close_tree(lm_caches_to_numpy(caches, case.tm), want)


def test_train_loss_matches_jax(case):
    with torch.inference_mode():
        loss, aux = case.tm.train_loss(_port_batch(case.batch))
    assert aux["lm_loss"] is loss
    _close_rel(loss.item(), case.loss)


def test_prefill_equals_stepwise_decode(case):
    """The port alone: prefill's last logits equal those of one-token
    decode steps over the same input from an empty cache (enc-dec: the
    cross caches filled from prefill's; vlm: continuing prefill of the
    prefix and the first half)."""
    tm = case.tm
    batch = _port_batch(case.batch)
    with torch.inference_mode():
        want, pre = tm.prefill(batch)
        caches = tm.init_cache(B, case.S)
        toks, start = batch["tokens"], 0
        if "prefix" in batch:
            half = {**batch, "tokens": toks[:, :L // 2]}
            _, part = tm.prefill(half)
            caches = tm.grow_caches(part, case.S)
            start = L // 2
        if "src" in batch:
            for c, p in zip(caches, pre):
                c["xk"][:], c["xv"][:] = p["xk"], p["xv"]
        off = case.ltot - L
        for t in range(start, L):
            got, caches = tm.decode_step(caches, toks[:, t], off + t)
    _close_logits(got.numpy(), want.numpy(), case.cfg.vocab)


def _shapes(vals):
    return [{k: tuple(t.shape) for k, t in layer.items()} for layer in vals]


def test_cache_and_param_shapes_match_jax(case):
    """``init_cache``/``cache_shapes``/``param_shapes`` against the JAX
    package's: each layer's leaf is a JAX leaf without the stacked
    ``"layers"`` axis; the shapes come on the ``meta`` device."""
    jm, tm = case.jm, case.tm
    jvals, jaxes = jm.cache_shapes(B, case.S)
    vals, axes = tm.cache_shapes(B, case.S)
    assert _shapes(tm.init_cache(B, case.S)) == _shapes(vals)
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for layer in vals for t in layer.values())
    for n, si, _, i in _layer_index(tm.segments):
        want = jvals[si][str(i)]
        assert {k: tuple(t.shape) for k, t in vals[n].items()} == \
            {k: tuple(sd.shape)[1:] for k, sd in want.items()}
        assert {k: ("layers",) + ax for k, ax in axes[n].items()} == \
            {k: tuple(sp) for k, sp in jaxes[si][str(i)].items()}
    pvals, paxes = tm.param_shapes()
    jpv, jpa = jm.param_shapes()
    flat_v = {"/".join(str(p.key) for p in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(jpv)[0]}
    flat_a = {"/".join(str(p.key) for p in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(
                  jpa, is_leaf=lambda x: isinstance(
                      x, jax.sharding.PartitionSpec))[0]}
    assert sum(int(np.prod(t.shape)) for t in pvals.values()) == \
        sum(int(np.prod(s.shape)) for s in flat_v.values())
    for key, t in pvals.items():
        assert t.device.type == "meta"
        parts = key.split(".")
        if parts[0] == "enc":
            parts = parts[1:]
            segs, pre = jm.enc_segments, "enc/"
        else:
            segs, pre = jm.segments, ""
        if parts[0] != "layers":
            jkey, stacked = pre + "/".join(parts), False
        else:
            layer = int(parts[1])
            for n, si, _, i in _layer_index(segs):
                if n == layer:
                    jkey = f"{pre}seg{si}/{i}/" + "/".join(parts[2:])
            stacked = True
        want_shape = tuple(flat_v[jkey].shape)[1 if stacked else 0:]
        want_axes = tuple(flat_a[jkey])[1 if stacked else 0:]
        assert tuple(t.shape) == want_shape, key
        assert paxes[key] == want_axes, key


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(window):
    rng = np.random.default_rng(7)
    q1 = rng.standard_normal((2, 8, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 2, 11, 16)).astype(np.float32)
              for _ in range(2))
    for pos in (0, 4, 10, 13):
        want = jattn.decode_attention(jnp.asarray(q1), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(pos),
                                      window=window)
        for p in (pos, torch.tensor(pos)):
            got = attention.decode_attention(
                torch.from_numpy(q1), torch.from_numpy(kc),
                torch.from_numpy(vc), p, window=window)
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                       atol=1e-6)


@pytest.mark.parametrize("pos", [0, 6, 10, 11, 14, -2, -20])
def test_cache_update_clamps_like_jax(pos):
    """In place, for an int and a 0-d tensor: S = 11, so 11 and 14
    overwrite the last entry; a negative position counts from the end
    (-2 writes 9) and is clamped at 0 (-20)."""
    rng = np.random.default_rng(8)
    kc, vc = (rng.standard_normal((2, 2, 11, 16)).astype(np.float32)
              for _ in range(2))
    k1, v1 = (rng.standard_normal((2, 2, 16)).astype(np.float32)
              for _ in range(2))
    wk, wv = jattn.cache_update(jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(k1), jnp.asarray(v1),
                                jnp.asarray(pos))
    for p in (pos, torch.tensor(pos)):
        k, v = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        gk, gv = attention.cache_update(k, v, torch.from_numpy(k1),
                                        torch.from_numpy(v1), p)
        assert gk is k and gv is v
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("chunk,masked", [(1024, "some"), (3, "some"),
                                          (5, "none"), (3, "all")])
def test_chunked_lm_loss_matches_jax(chunk, masked):
    """A padded vocab (500 of 512), chunks smaller than L = 8 with a
    ragged last chunk, and all targets masked (the count is clamped at
    1, so the loss is 0)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    head = rng.standard_normal((16, 512)).astype(np.float32)
    targets = rng.integers(0, 500, (2, 8)).astype(np.int32)
    mask = {"some": rng.random((2, 8)) < 0.6, "none": np.ones((2, 8), bool),
            "all": np.zeros((2, 8), bool)}[masked].astype(np.float32)
    want = float(jchunked_lm_loss(jnp.asarray(x), jnp.asarray(head),
                                  jnp.asarray(targets), jnp.asarray(mask),
                                  chunk=chunk, vocab_real=500))
    got = chunked_lm_loss(torch.from_numpy(x), torch.from_numpy(head),
                          torch.from_numpy(targets), torch.from_numpy(mask),
                          chunk=chunk, vocab_real=500).item()
    if masked == "all":
        assert got == want == 0.0
    else:
        _close_rel(got, want)


def test_local_ring_shorter_than_window():
    """L = 5 < w = 8: prefill's local caches hold 5 entries (the roll is
    the identity); grown into the w-slot ring they decode as in JAX."""
    over = dict(local_global_pattern="LLG", n_layers=4, sliding_window=8)
    jm = jget_model("tinyllama-1.1b", reduced=True, remat="none", **over)
    tree = _perturb_norms(jlayers.values(jm.init(jax.random.key(1))), 2)
    tm = get_model("tinyllama-1.1b", reduced=True, device="cpu", **over)
    tm.load_state_dict(lm_state_from_numpy(_np_tree(tree), tm))
    toks = np.random.default_rng(3).integers(0, 512, (B, 5)).astype(np.int32)
    decode = jax.jit(jm.decode_step)
    jl, jc = jax.jit(jm.prefill)(tree, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tc = tm.prefill({"tokens": torch.from_numpy(toks)})
    assert [tuple(c["k"].shape) for c in tc] == [(B, 2, 5, 32)] * 4
    _close_logits(tl.numpy(), np.asarray(jl), 512)
    _close_tree(lm_caches_to_numpy(tc, tm), _np_tree(jc))
    grown = _grow_np(_np_tree(jc), _np_tree(jlayers.values(
        jm.init_cache(B, 12))))
    tc = tm.grow_caches(tc, 12)
    cur = grown
    for t, pos in enumerate(range(5, 11)):         # the ring wraps at 8
        tok = np.full((B,), 7 * t + 1, np.int32)
        jl, cur = decode(tree, cur, jnp.asarray(tok), jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tc, tok, pos)
        _close_logits(tl.numpy(), np.asarray(jl), 512)
    _close_tree(lm_caches_to_numpy(tc, tm), _np_tree(cur))


@pytest.mark.parametrize("axes,names", [
    ((2, 4), ("data", "model")), ((1, 2, 2), ("pod", "data", "model"))],
    ids=["data-model", "pod-data-model"])
def test_make_rules_and_logical_to_spec_match_jax(axes, names):
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(
        (1,) * len(names)), names)
    mesh = make_mesh(axes, names, device="cpu")
    tm = get_model("tinyllama-1.1b", reduced=True, device="cpu",
                   local_global_pattern="LLG", n_layers=4, sliding_window=8)
    _, paxes = tm.param_shapes()
    _, caxes = tm.cache_shapes(2, 16)
    logical = list(paxes.values()) + [("layers",) + ax for layer in caxes
                                      for ax in layer.values()]
    for kind in ("train", "decode"):
        for long_context in (False, True):
            want = jsharding.make_rules(jmesh, kind, long_context)
            got = make_rules(mesh, kind, long_context)
            assert got == want
            for ax in logical + [("kv_seq", "unknown", None)]:
                assert logical_to_spec(ax, got) == tuple(
                    jsharding.logical_to_spec(
                        jax.sharding.PartitionSpec(*ax), want))


# ---------------------------------------------------------------------------
# on the card: the kernel run's prefill against the plain attention's
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode "
                    "(chip_smoke.py phase 3j runs this check on the card)")
    return torch.device("cuda")


def _plain(q, k, v, *, causal=True, window=None, scale=None):
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
def test_card_prefill_kernel_matches_plain(cuda_dev, name):
    tm = get_model("tinyllama-1.1b", reduced=True, seed=1,
                   **VARIANTS[name][0])
    batch = _port_batch(_batch(name, tm.cfg, seed=2, length=40))
    before = ops.launch_counts()["flash_attention"]
    got, gc = tm.prefill(batch)
    torch.cuda.synchronize()
    n = len(tm.layers) * (2 if "src" in batch else 1) + (
        tm.cfg.encoder_layers if "src" in batch else 0)
    assert ops.launch_counts()["flash_attention"] == before + n
    with mock.patch.object(ops, "flash_attention", _plain):
        want, wc = tm.prefill(batch)
    _close_logits(got.cpu().numpy(), want.cpu().numpy(), tm.cfg.vocab)
    _close_tree(lm_caches_to_numpy(gc, tm), lm_caches_to_numpy(wc, tm))
