"""Import guard and entry-point rules of the PyTorch port.

* Every module of ``repro_torch`` (and ``chip_smoke.py``) imports with
  ``jax`` and ``repro`` blocked: the port never needs the JAX package.
* No ``torch.topk`` anywhere in the port: its tie order is not the
  reference's lowest-index-first (``ref.stable_topk`` is the one top-k).
* The entry points (the drivers, ``make_index``, ``get_model``,
  ``EmbeddingServer``, ``RetrievalServer``, the cluster coordinator and
  a worker's ``init``) run on the card by default
  and raise without one unless the caller asks for the CPU; the planes
  that once raised ``NotImplementedError`` run: the quant plane
  (``use_pq``), the cold tier (``use_tier``), the fused tick, and the
  backbone's decode path (``prefill``, ``decode_step``, ``qk_norm``).
* Every kernel of ``ops.KERNELS`` names a CUDA source that ``_nvcc``
  builds, and every source is built for some kernel.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import make_index
from repro_torch.core.driver import UBISDriver
from repro_torch.core.spfresh import SPFreshDriver
from repro_torch.core.types import UBISConfig
from repro_torch.launch.serve import (EmbeddingServer, RetrievalServer,
                                      ServeConfig)
from repro_torch.models import get_model

ROOT = Path(__file__).resolve().parent.parent

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port imported {name}")
        return None

for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "repro"):
        del sys.modules[name]
sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "repro"))
assert not bad, bad
for m in ("repro_torch.quant.pq", "repro_torch.models.transformer",
          "repro_torch.serving.engine", "repro_torch.launch.serve",
          "repro_torch.obs.probe", "repro_torch.kernels.flash_attention",
          "repro_torch.core.tier", "repro_torch.kernels.posting_scan",
          "repro_torch.kernels.pq_scan", "repro_torch.core.sharded",
          "repro_torch.api.sharded_driver", "repro_torch.api.rebalance",
          "repro_torch.distributed.sharding",
          "repro_torch.distributed.straggler",
          "repro_torch.cluster.worker", "repro_torch.cluster.coordinator",
          "repro_torch.cluster.backend", "repro_torch.cluster.protocol",
          "repro_torch.checkpoint", "repro_torch.checkpoint.manager"):
    assert m in mods, (m, mods)
print(len(mods))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _GUARD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 41      # every module was walked


def test_no_torch_topk_in_the_port():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += list((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu*"))
    files.append(ROOT / "chip_smoke.py")
    hits = [str(f) for f in files if "torch.topk" in f.read_text()]
    assert not hits, hits


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24,
                     cache_capacity=64, max_ids=1 << 10)
    seeds = np.random.default_rng(0).normal(size=(60, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        UBISDriver(cfg, seeds)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_index("ubis", cfg, seeds)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("tinyllama-1.1b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingServer(ServeConfig(reduced=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalServer(ServeConfig(reduced=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_index("ubis-cluster", cfg, seeds)
    from repro_torch.cluster.worker import WorkerRuntime
    from repro_torch.cluster.protocol import cfg_to_payload
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkerRuntime().handle("init", {"cfg": cfg_to_payload(cfg),
                                        "seed_vectors": seeds})
    assert make_index("spfresh", cfg, seeds, device="cpu").cfg.mode == \
        "spfresh"
    assert SPFreshDriver(cfg, seeds, device="cpu").cfg.mode == "spfresh"


# The case ids are the ones these cases had when the quant plane, the
# cold tier, the fused tick and the decode path still raised; every case
# now checks that its plane runs.
@pytest.mark.parametrize("kw,what", [
    pytest.param(dict(use_pq=True, pq_m=4), None, id="kw0-quant plane"),
    pytest.param(dict(use_pq=True, pq_m=4, use_tier=True), None,
                 id="kw1-quant plane"),
    pytest.param(dict(fused_tick=True), None, id="kw2-fused_tick"),
    pytest.param(dict(lm="prefill"), None, id="lm-prefill"),
    pytest.param(dict(lm="decode_step"), None, id="lm-decode_step"),
    pytest.param(dict(lm_cfg=dict(qk_norm=True)), None, id="lm-qk_norm"),
])
def test_later_slices_raise_not_implemented(kw, what):
    kw = dict(kw)
    if "lm" in kw or "lm_cfg" in kw:
        lm = get_model("tinyllama-1.1b", reduced=True, device="cpu",
                       **kw.get("lm_cfg", {}))
        assert ("q_norm" in lm.layers[0].attn) == ("lm_cfg" in kw)
        tokens = np.zeros((1, 4), np.int32)
        logits, caches = lm.prefill({"tokens": tokens})
        assert logits.shape == (1, 512) and torch.isfinite(logits).all()
        assert [tuple(c["k"].shape) for c in caches] == [(1, 2, 4, 32)] * 2
        if kw.get("lm") == "decode_step":
            caches = lm.init_cache(1, 8)
            logits, out = lm.decode_step(caches, tokens[:, 0], 0)
            assert out is caches and logits.shape == (1, 512)
            assert caches[0]["k"][:, :, 0].abs().sum() > 0
        return
    fused = kw.pop("fused_tick", False)
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24,
                     cache_capacity=64, max_ids=1 << 10, **kw)
    seeds = np.random.default_rng(0).normal(size=(60, 8)).astype(np.float32)
    if what is None:
        drv = UBISDriver(cfg, seeds, device="cpu", fused_tick=fused)
        assert drv.fused_tick == fused
        assert drv.state.codes.shape == ((64, 4, 32) if cfg.use_pq
                                         else (64, 1, 32))
        assert (drv.tier is not None) == cfg.use_tier
        return
    with pytest.raises(NotImplementedError, match=what):
        UBISDriver(cfg, seeds, device="cpu", fused_tick=fused)


def test_every_kernel_source_is_built():
    from repro_torch.kernels import _nvcc, ops
    names = set(_nvcc.kernel_names())
    sources = {src for _, _, src, _ in ops.KERNELS.values()}
    assert {Path(s).stem for s in sources} == names
    for name in ("posting_scan_gather", "pq_scan_gather"):
        assert name in names
        assert ops.KERNELS[name][2] == f"src/repro_torch/csrc/{name}.cu"
    for src in sources:
        assert (ROOT / src).is_file(), src
    assert ops.KERNELS["posting_scan_gather"][3] == \
        "src/repro/kernels/posting_scan.py:118"
    assert ops.KERNELS["pq_scan_gather"][3] == \
        "src/repro/kernels/pq_scan.py:78"


def test_unknown_engine_raises():
    """No engine of the JAX registry is refused as unported any more
    (``ubis-cluster`` was the last); a name outside it raises."""
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24)
    assert make_index("ubis-cluster", cfg, np.zeros((60, 8), np.float32),
                      device="cpu").n_workers == 1
    with pytest.raises(ValueError, match="unknown engine"):
        make_index("ubis-cluster-2", cfg, np.zeros((60, 8), np.float32),
                   device="cpu")
