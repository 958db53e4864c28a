"""The benchmark's data: clustered vectors whose centres drift, from a seed.

A frozen copy of ``chip_smoke.py``'s ``Stream`` and ``QUANT_DATA``
(lines 1147-1191 at commit bd85f0a), kept here so that no later change
to the program moves the yardstick.  The distribution is the original's;
the draws are made with a ``torch.Generator`` on the run's device in a
few large calls instead of numpy on the host:

* the centres are N(0, scale^2 I);
* ``tau=None``: each vector is its centre plus isotropic N(0, I) noise.
  Else the spread has a decaying spectrum, like real descriptor data:
  its standard deviation along the i-th axis of a random rotation is
  proportional to exp(-i / tau), the total variance staying ``dim``;
* before each streaming step the centres drift by N(0, drift^2 I), and
  the step's fresh vectors are drawn around the drifted centres.

Ids are rows: the load holds ids ``0 .. n-1``, step ``s`` (0 = the
warm-up) inserts ``n + s * fresh ..``, so the whole stream is one array.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

BLOCK_ROWS = 1 << 18          # rows drawn on the device per host copy


def derived_seed(seed: int, label: str) -> int:
    """A 63-bit seed for one named draw of run ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class StreamData:
    """Every input of a run, on the host: ``vectors`` (n + steps * fresh,
    d) float32, row = id; ``queries`` (query_sets, Q, d) float32."""

    vectors: np.ndarray
    queries: np.ndarray
    n: int
    fresh: int
    steps: int

    def step_ids(self, s: int) -> np.ndarray:
        lo = self.n + s * self.fresh
        return np.arange(lo, lo + self.fresh)

    def first_window_id(self) -> int:
        """The first id the measured window inserts (step 1's)."""
        return self.n + self.fresh

    def step_vectors(self, s: int) -> np.ndarray:
        lo = self.n + s * self.fresh
        return self.vectors[lo:lo + self.fresh]


class Stream:
    """Clustered vectors whose cluster centres drift between steps."""

    def __init__(self, dim: int, n_clusters: int, gen: torch.Generator,
                 device, tau=None, scale: float = 3.0):
        self.gen, self.device, self.dim = gen, device, dim
        self.centers = torch.randn(n_clusters, dim, generator=gen,
                                   device=device) * scale
        self.basis = None
        if tau is not None:
            g = torch.randn(dim, dim, generator=gen, device=device,
                            dtype=torch.float64)
            rot = torch.linalg.qr(g)[0]
            sd = torch.exp(-torch.arange(dim, device=device,
                                         dtype=torch.float64) / tau)
            sd *= torch.sqrt(dim / (sd * sd).sum())
            self.basis = (sd[:, None] * rot).to(torch.float32)

    def draw(self, n: int) -> torch.Tensor:
        a = torch.randint(0, self.centers.shape[0], (n,), generator=self.gen,
                          device=self.device)
        x = torch.randn(n, self.dim, generator=self.gen, device=self.device)
        if self.basis is not None:
            x = x @ self.basis
        return x.add_(self.centers[a])

    def drift(self, step: float) -> None:
        self.centers += torch.randn(self.centers.shape, generator=self.gen,
                                    device=self.device) * step


def make_stream(data: dict, dim: int, fresh: int, steps: int,
                query_sets: int, queries: int, seed: int,
                device) -> StreamData:
    """The load (``data["n"]`` vectors), a fixed pool of ``query_sets``
    batches of ``queries`` (drawn around the load's centres) and
    ``steps`` streaming steps of ``fresh`` vectors, all from ``seed``.
    Rows are drawn on ``device`` into blocks of about ``BLOCK_ROWS`` and
    each block copied to the host in one call."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "stream"))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # the basis product
    try:
        st = Stream(dim, int(data["clusters"]), gen, device,
                    tau=data.get("tau"), scale=float(data["scale"]))
        n = int(data["n"])
        out = torch.empty(n + steps * fresh, dim, dtype=torch.float32)
        for off in range(0, n, BLOCK_ROWS):
            out[off:min(n, off + BLOCK_ROWS)] = st.draw(
                min(n, off + BLOCK_ROWS) - off).cpu()
        qs = st.draw(query_sets * queries).reshape(query_sets, queries,
                                                   dim).cpu()
        per = max(1, BLOCK_ROWS // max(1, fresh))     # steps a block
        for s0 in range(0, steps, per):
            block = []
            for _ in range(s0, min(steps, s0 + per)):
                st.drift(float(data["drift"]))
                block.append(st.draw(fresh))
            lo = n + s0 * fresh
            out[lo:lo + len(block) * fresh] = torch.cat(block).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return StreamData(vectors=out.numpy(), queries=qs.numpy(), n=n,
                      fresh=fresh, steps=steps)
