"""Import guard and entry-point rules of the PyTorch port.

* Every module of ``repro_torch`` (and ``chip_smoke.py``) imports with
  ``jax`` and ``repro`` blocked: the port never needs the JAX package.
* No ``torch.topk`` anywhere in the port: its tie order is not the
  reference's lowest-index-first (``ref.stable_topk`` is the one top-k).
* The entry points (the drivers, ``make_index``, ``get_model``,
  ``EmbeddingServer``, ``RetrievalServer``) run on the card by default
  and raise without one unless the caller asks for the CPU; the planes
  of later slices (the cold tier, the fused tick, the decode path)
  raise ``NotImplementedError`` instead of being ignored, and the quant
  plane (``use_pq``) runs.
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
          "repro_torch.obs.probe", "repro_torch.kernels.flash_attention"):
    assert m in mods, (m, mods)
print(len(mods))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _GUARD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 35      # every module was walked


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
    assert make_index("spfresh", cfg, seeds, device="cpu").cfg.mode == \
        "spfresh"
    assert SPFreshDriver(cfg, seeds, device="cpu").cfg.mode == "spfresh"


# The case ids are the ones these cases had when the quant plane still
# raised; the first case now checks that it runs instead.
@pytest.mark.parametrize("kw,what", [
    pytest.param(dict(use_pq=True, pq_m=4), None, id="kw0-quant plane"),
    pytest.param(dict(use_pq=True, pq_m=4, use_tier=True), "cold tier",
                 id="kw1-quant plane"),
    pytest.param(dict(fused_tick=True), "fused_tick", id="kw2-fused_tick"),
    pytest.param(dict(lm="prefill"), "decode slice", id="lm-prefill"),
    pytest.param(dict(lm="decode_step"), "decode slice",
                 id="lm-decode_step"),
    pytest.param(dict(lm_cfg=dict(qk_norm=True)), "qk_norm",
                 id="lm-qk_norm"),
])
def test_later_slices_raise_not_implemented(kw, what):
    kw = dict(kw)
    if "lm_cfg" in kw:
        with pytest.raises(NotImplementedError, match=what):
            get_model("tinyllama-1.1b", reduced=True, device="cpu",
                      **kw["lm_cfg"])
        return
    if "lm" in kw:
        lm = get_model("tinyllama-1.1b", reduced=True, device="cpu")
        with pytest.raises(NotImplementedError, match=what):
            getattr(lm, kw["lm"])({"tokens": np.zeros((1, 4), np.int32)})
        return
    fused = kw.pop("fused_tick", False)
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24,
                     cache_capacity=64, max_ids=1 << 10, **kw)
    seeds = np.random.default_rng(0).normal(size=(60, 8)).astype(np.float32)
    if what is None:
        drv = UBISDriver(cfg, seeds, device="cpu", fused_tick=fused)
        assert drv.cfg.use_pq and drv.state.codes.shape == (64, 4, 32)
        return
    with pytest.raises(NotImplementedError, match=what):
        UBISDriver(cfg, seeds, device="cpu", fused_tick=fused)


def test_unknown_engine_raises():
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24)
    for engine in ("spann", "freshdiskann", "ubis-sharded", "ubis-cluster"):
        with pytest.raises(ValueError, match="not ported"):
            make_index(engine, cfg, np.zeros((60, 8), np.float32),
                       device="cpu")
