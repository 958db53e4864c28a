"""Import guard and entry-point rules of the PyTorch port.

* Every module of ``repro_torch`` (and ``chip_smoke.py``) imports with
  ``jax`` and ``repro`` blocked: the port never needs the JAX package.
* No ``torch.topk`` anywhere in the port: its tie order is not the
  reference's lowest-index-first (``ref.stable_topk`` is the one top-k).
* The entry points run on the card by default and raise without one
  unless the caller asks for the CPU; the planes of later slices raise
  ``NotImplementedError`` instead of being ignored.
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
print(len(mods))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _GUARD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 15      # every module was walked


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
    assert make_index("spfresh", cfg, seeds, device="cpu").cfg.mode == \
        "spfresh"
    assert SPFreshDriver(cfg, seeds, device="cpu").cfg.mode == "spfresh"


@pytest.mark.parametrize("kw,what", [
    (dict(use_pq=True, pq_m=4), "quant plane"),
    (dict(use_pq=True, pq_m=4, use_tier=True), "quant plane"),
    (dict(fused_tick=True), "fused_tick"),
])
def test_later_slices_raise_not_implemented(kw, what):
    kw = dict(kw)
    fused = kw.pop("fused_tick", False)
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24,
                     cache_capacity=64, max_ids=1 << 10, **kw)
    seeds = np.random.default_rng(0).normal(size=(60, 8)).astype(np.float32)
    with pytest.raises(NotImplementedError, match=what):
        UBISDriver(cfg, seeds, device="cpu", fused_tick=fused)


def test_unknown_engine_raises():
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24)
    for engine in ("spann", "freshdiskann", "ubis-sharded", "ubis-cluster"):
        with pytest.raises(ValueError, match="not ported"):
            make_index(engine, cfg, np.zeros((60, 8), np.float32),
                       device="cpu")
