"""The port's embed backbone against the JAX package, on the same inputs.

* ``flash_attention``: the port's plain version (what ``kernels.ops``
  runs on a CPU tensor) against JAX ``ref.flash_attention``, the Pallas
  kernel in interpret mode (as tests/test_kernels.py runs it) and the
  model's ``chunked_attention``/``local_attention`` with
  ``backend="off"``, at tests/test_kernels.py's 12 shapes and its
  tolerance, 2e-4 abs and rel (softmax is not exact on real data).  On
  these shapes every query row has at least one valid key: a row with
  none has no right answer (the JAX reference gives NaN, the kernels a
  tiling-dependent average of v), so none is compared.
* ``rms_norm``, ``rope`` and ``swiglu`` at 1e-6.
* The reduced tinyllama (2 layers, d 128, 4/2 heads, head dim 32, vocab
  512) and a reduced local/global variant with the JAX package's
  weights carried across (``bridge.lm_state_from_numpy``): hidden states
  and ``EmbeddingServer.embed`` within 1e-4 of the largest magnitude
  (fp32 matmuls summed in another order, through every layer).

The ``cuda``-marked tests hold the CUDA kernel against its plain
version on the card and skip without one (``chip_smoke.py`` runs the
same checks there).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import EmbeddingServer as JEmbeddingServer
from repro.launch.serve import ServeConfig as JServeConfig
from repro.models import get_model as jget_model
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.transformer import run_segments as jrun_segments
from repro_torch.bridge import lm_state_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import EmbeddingServer, ServeConfig
from repro_torch.models import attention, get_model, layers

TOL = 2e-4           # tests/test_kernels.py:127

# (Lq, Lk, D, Hq, Hkv) x causal x window: tests/test_kernels.py:114-117
SHAPES = [(37, 53, 16, 4, 2), (64, 64, 32, 2, 2), (16, 128, 64, 8, 1)]
CASES = [(*s, c, w) for s in SHAPES for c in (True, False)
         for w in (None, 9)]
IDS = [f"{lq}x{lk}-d{d}-h{hq}/{hkv}-{'causal' if c else 'full'}-w{w}"
       for lq, lk, d, hq, hkv, c, w in CASES]


def _qkv(Lq, Lk, D, Hq, Hkv, seed=0, B=2):
    rng = np.random.default_rng(seed + Lq * 7 + Lk)
    return (rng.normal(size=(B, Hq, Lq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Lk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Lk, D)).astype(np.float32))


def _port(q, k, v, causal, window):
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    return out.numpy()


def _rows_with_a_key(Lq, Lk, causal):
    qpos = np.arange(Lq) + Lk - Lq
    return qpos >= 0 if causal else np.ones(Lq, bool)


def _check(got, want, Lq, Lk, causal):
    rows = _rows_with_a_key(Lq, Lk, causal)
    assert rows.all()                      # true of all 12 shapes
    np.testing.assert_allclose(got[:, :, rows], np.asarray(want)[:, :, rows],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("Lq,Lk,D,Hq,Hkv,causal,window", CASES, ids=IDS)
def test_plain_flash_attention_matches_jax_ref(Lq, Lk, D, Hq, Hkv, causal,
                                               window):
    q, k, v = _qkv(Lq, Lk, D, Hq, Hkv)
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window)
    _check(_port(q, k, v, causal, window), want, Lq, Lk, causal)


@pytest.mark.parametrize("Lq,Lk,D,Hq,Hkv,causal,window", CASES, ids=IDS)
def test_plain_flash_attention_matches_pallas_interpret(Lq, Lk, D, Hq, Hkv,
                                                        causal, window):
    q, k, v = _qkv(Lq, Lk, D, Hq, Hkv, seed=1)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                backend="pallas")
    _check(_port(q, k, v, causal, window), want, Lq, Lk, causal)


@pytest.mark.parametrize("Lq,Lk,D,Hq,Hkv,causal,window", CASES, ids=IDS)
def test_chunked_attention_matches_jax(Lq, Lk, D, Hq, Hkv, causal, window):
    """The JAX model's chunked path (``backend="off"``) takes the global
    position of q row 0 as ``q_offset``; the kernels align the ends, so
    it gets ``Lk - Lq``.  Small chunks make it carry its online softmax
    over several key chunks."""
    q, k, v = _qkv(Lq, Lk, D, Hq, Hkv, seed=2)
    want = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=Lk - Lq, chunk_q=16, chunk_k=32,
        backend="off")
    got = attention.chunked_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal,
                                      window=window).numpy()
    _check(got, want, Lq, Lk, causal)


@pytest.mark.parametrize("L,window,Hq,Hkv", [(64, 9, 2, 2), (96, 32, 4, 2),
                                             (50, 7, 8, 1)])
def test_local_attention_matches_jax(L, window, Hq, Hkv):
    q, k, v = _qkv(L, L, 16, Hq, Hkv, seed=3)
    want = jattn.local_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window, backend="off")
    got = attention.local_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), window).numpy()
    _check(got, want, L, L, True)


def test_rms_norm_rope_swiglu_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 24, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)), rtol=0, atol=1e-6)
    pos = np.arange(24)
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(x), torch.from_numpy(pos)[None, None],
                    10000.0).numpy(),
        jlayers.rope(jnp.asarray(x), jnp.asarray(pos)[None, None], 10000.0),
        rtol=0, atol=1e-6)
    h = rng.normal(size=(5, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.swiglu(*map(torch.from_numpy, (h, wg, wu, wd))).numpy(),
        jlayers.swiglu(*map(jnp.asarray, (h, wg, wu, wd))), rtol=0, atol=1e-6)


def _close_rel(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _jax_tree(jm, seed=0):
    tree = jlayers.values(jm.init(jax.random.key(seed)))
    return tree, jax.tree_util.tree_map(np.asarray, tree)


def _jax_hidden(jm, tree, tokens):
    x = jnp.take(tree["emb"], jnp.asarray(tokens), axis=0)
    x = jrun_segments(tree, jm.cfg, jm.segments, x,
                      jnp.arange(tokens.shape[1]), remat="none")
    return jlayers.rms_norm(x, tree["ln_f"], jm.cfg.norm_eps)


# (overrides of the reduced config, tokens (B, L)): the reduced tinyllama;
# a local/global variant with a tail segment (pattern LLG over 4 layers:
# one period, then one more local layer), window 16 over 40 tokens
MODEL_CASES = [({}, (3, 24)),
               (dict(local_global_pattern="LLG", n_layers=4,
                     sliding_window=16), (2, 40))]


@pytest.mark.parametrize("over,shape", MODEL_CASES,
                         ids=["tinyllama-reduced", "local-global"])
def test_reduced_backbone_matches_jax(over, shape):
    jm = jget_model("tinyllama-1.1b", reduced=True, remat="none", **over)
    tree, np_tree = _jax_tree(jm)
    tm = get_model("tinyllama-1.1b", reduced=True, device="cpu", **over)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert [len(d) * r for d, r in tm.segments] == \
        [len(d) * r for d, r in jm.segments]
    tm.load_state_dict(lm_state_from_numpy(np_tree, tm))
    tokens = np.random.default_rng(5).integers(
        0, tm.cfg.vocab, shape).astype(np.int32)
    want = _jax_hidden(jm, tree, tokens)
    with torch.inference_mode():
        got = tm.hidden(torch.from_numpy(tokens))
    _close_rel(got.numpy(), want)


def test_embedding_server_matches_jax():
    """The JAX server's own draws (``LM.init`` and ``proj``), injected into
    the port's server."""
    jcfg = JServeConfig(reduced=True, embed_dim=16, seed=3)
    js = JEmbeddingServer(jcfg)
    tcfg = ServeConfig(reduced=True, embed_dim=16, seed=3, device="cpu")
    ts = EmbeddingServer(
        tcfg, params=jax.tree_util.tree_map(np.asarray, js.params),
        proj=np.asarray(js.proj))
    tokens = np.random.default_rng(6).integers(0, 512, (4, 32)).astype(
        np.int32)
    _close_rel(ts.embed(tokens), js.embed(tokens))


def test_weight_bridge_checks_shapes():
    jm = jget_model("tinyllama-1.1b", reduced=True, remat="none")
    _, np_tree = _jax_tree(jm)
    tm = get_model("tinyllama-1.1b", reduced=True, device="cpu", d_ff=128)
    with pytest.raises(ValueError, match="shape"):
        lm_state_from_numpy(np_tree, tm)


def test_model_draws_are_seeded():
    a = get_model("tinyllama-1.1b", reduced=True, device="cpu", seed=7)
    b = get_model("tinyllama-1.1b", reduced=True, device="cpu", seed=7)
    c = get_model("tinyllama-1.1b", reduced=True, device="cpu", seed=8)
    assert torch.equal(a.layers[1].mlp["w_up"], b.layers[1].mlp["w_up"])
    assert not torch.equal(a.emb, c.emb)
    assert a.layers[0].attn["wq"].shape == (128, 4 * 32)
    assert a.layers[0].attn["wk"].shape == (128, 2 * 32)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode "
                    "(chip_smoke.py runs this check on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,D,Hq,Hkv,causal,window", CASES, ids=IDS)
def test_card_flash_attention_kernel(cuda_dev, Lq, Lk, D, Hq, Hkv, causal,
                                     window):
    q, k, v = (torch.as_tensor(a, device=cuda_dev)
               for a in _qkv(Lq, Lk, D, Hq, Hkv, seed=9))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    _check(got.cpu().numpy(), want.cpu().numpy(), Lq, Lk, causal)


@pytest.mark.cuda
def test_card_flash_attention_refuses_wide_heads(cuda_dev):
    q = torch.zeros((1, 2, 8, 129), device=cuda_dev)
    k = torch.zeros((1, 1, 8, 129), device=cuda_dev)
    with pytest.raises(ValueError, match="D=129"):
        ops.flash_attention(q, k, k)


@pytest.mark.cuda
def test_card_embedder_kernel_matches_plain(cuda_dev):
    """One embedded batch through the kernel and through the plain
    attention on the same card, within 1e-4 of the embedding's scale."""
    es = EmbeddingServer(ServeConfig(reduced=True, embed_dim=16))
    tokens = np.random.default_rng(8).integers(0, 512, (4, 96)).astype(
        np.int32)
    got = es.embed(tokens)

    def plain(q, k, v, *, causal=True, window=None, scale=None):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)

    with mock.patch.object(ops, "flash_attention", plain):
        want = es.embed(tokens)
    _close_rel(got, want)
