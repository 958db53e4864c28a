"""The cluster worker: the sharded driver behind the command protocol.

A worker owns ONE ``ShardedUBISDriver`` (its mesh: the logical shards of
its device) and exposes the driver's plan/execute halves as protocol
commands; it makes no planning decisions.  The coordinator owns every
planner (rebalance, tier, PQ cadence, insert routing) and drives the
worker through the three tick legs:

  ``tick_begin`` - run the sharded background program; ship the
                   pressure rows up (plus executed/GC counts);
  ``tick_exec``  - execute the coordinator's migrate moves, drain the
                   cache, run the retrain slot if granted; ship the tier
                   observation rows up;
  ``tick_end``   - execute the coordinator's spill/promote lanes
                   (dispatch + reconcile under staleness signatures);
                   ship the commit log + occupancy report up.

``tick_exec`` and ``tick_end`` call the driver's tier manager directly
(``observe``, ``dispatch_planned``, ``reconcile``), not through the
driver's own tick, so they write through the global view and must then
broadcast the replicated fields to every shard
(``ShardedState.replicate()``, as the driver's own tier paths do):
without it the next sharded program reads a stale replica.

The driver is built with ``Obs(enabled=False)``: the stats mapping stays
live but tracing is a no-op; decisions are traced on the coordinator's
plane, and the worker ships its tier ``commit_log`` up.

Arrays arrive as numpy and go to the worker's device once, inside the
driver's calls; every reply converts tensors to numpy
(``.cpu().numpy()``).  The codec refuses anything else, so a tensor in a
reply fails the command loudly.  On the card the driver's programs run
the CUDA kernels through the ``ops`` wrappers, as ``ubis-sharded`` does:
a kernel that fails to build or launch fails the command, and the
coordinator's call raises ``WorkerError``.

Run as a subprocess via ``python -m repro_torch.cluster.worker``: frames
in on stdin, frames out on stdout.  ``main`` duplicates the real fd 1
into a private handle and points fd 1 at stderr before it loads the
driver, the planners or a CUDA context, so no stray ``print`` or library
message can corrupt the frame stream (the package's own ``import
torch``, for its TF32 settings, writes nothing there).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from . import protocol


def _np(x):
    """A reply value as numpy: tensors leave the device here."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x


def logical_mesh(cfg, devices: int, device, shape=None):
    """A worker's mesh (``repro/cluster/worker.py:75``): ``shape``
    (data, model), or without it the JAX rule over the worker's
    ``devices`` (its ``--devices`` count): ``model_shards(max_postings,
    devices)`` shards on the ``model`` axis.  The shard count never
    depends on the host's cards; only where the D x S cells live does:

      * ``device`` is ``"cuda"`` with no index and the process sees at
        least D·S > 1 cards: cell i (row-major) on card i, the worker's
        own cards;
      * otherwise (a named card such as ``"cuda:1"``, fewer cards than
        cells, one card, the CPU): every cell on ``device``, as workers
        that share one card run.

    Either layout gives the same answers bit for bit."""
    import math

    import torch

    from ..core.driver import resolve_device
    from ..distributed import make_mesh, model_shards
    dev = resolve_device(device)
    if shape is None:
        shape = (1, model_shards(cfg.max_postings, devices))
    shape = tuple(int(n) for n in shape)
    n = math.prod(shape)
    if (dev.type == "cuda" and dev.index is None
            and 1 < n <= torch.cuda.device_count()):
        return make_mesh(shape, ("data", "model"),
                         devices=[torch.device("cuda", j) for j in range(n)])
    return make_mesh(shape, ("data", "model"), device=dev)


class WorkerRuntime:
    """Command dispatch over one driver (backend-agnostic: the
    LocalBackend calls ``handle`` in-process, the subprocess ``main``
    loop calls it behind stdin/stdout frames).  ``devices``: the logical
    shards of the default mesh (``init`` without ``mesh_shape``)."""

    def __init__(self, devices: int = 1):
        self.drv = None
        self.worker = 0
        self.devices = int(devices)
        self._tier_rows: Optional[dict] = None

    # ------------------------------------------------------------- util

    def handle(self, kind: str, payload: dict) -> dict:
        fn = getattr(self, "_cmd_" + kind, None)
        if fn is None:
            raise protocol.ProtocolError(f"unknown command {kind!r}")
        if self.drv is None and kind not in ("init", "ping", "sleep",
                                             "shutdown", "modules"):
            raise protocol.ProtocolError(f"{kind!r} before init")
        return fn(payload)

    def _replicate(self) -> None:
        """Broadcast the global view's replicated fields to every shard
        after a write through it (the JAX worker's ``_repin``)."""
        self.drv._sh.replicate()

    # ---------------------------------------------------------- control

    def _cmd_init(self, p: dict) -> dict:
        from ..api.sharded_driver import ShardedUBISDriver
        from ..core.driver import resolve_device
        from ..obs import Obs
        cfg = protocol.payload_to_cfg(p["cfg"])
        device = resolve_device(p.get("device"))
        mesh = logical_mesh(cfg, self.devices, device, p.get("mesh_shape"))
        kw = dict(p.get("kwargs") or {})
        for name in ("kmeans_init", "pq_init", "pq_keys"):
            if p.get(name) is not None:
                kw[name] = p[name]
        self.worker = int(p.get("worker", 0))
        self._tier_rows = None
        self.drv = ShardedUBISDriver(
            cfg, np.asarray(p["seed_vectors"], np.float32), mesh=mesh,
            obs=Obs(enabled=False), **kw)
        return {"n_shards": self.drv.n_shards, "devices": self.devices,
                "device": str(self.drv.device)}

    def _cmd_ping(self, p: dict) -> dict:
        return {"ok": True, "worker": self.worker}

    def _cmd_sleep(self, p: dict) -> dict:
        # test hook: fake a straggling worker
        time.sleep(float(p["seconds"]))
        return {"ok": True}

    def _cmd_shutdown(self, p: dict) -> dict:
        return {"ok": True}

    def _cmd_modules(self, p: dict) -> dict:
        """The top-level packages this process has imported (the import
        guard: no ``jax`` and no ``repro`` in a worker)."""
        import sys
        return {"modules": sorted({m.split(".")[0] for m in sys.modules})}

    def _cmd_placement(self, p: dict) -> dict:
        """Each cell's device, row by row, after ``core.sharded.
        audit_placement`` (which raises if a cell's tensor is elsewhere or
        shared)."""
        from ..core.sharded import audit_placement
        audit_placement(self.drv._sh)
        return {"devices": [str(d) for d in self.drv._sh.devices]}

    def _cmd_launches(self, p: dict) -> dict:
        """This process's kernel launch counts (``ops.launch_counts``);
        ``reset`` zeroes them first."""
        from ..kernels import ops
        if p.get("reset"):
            ops.reset_launch_counts()
        return {"launches": {k: int(v)
                             for k, v in ops.launch_counts().items()}}

    # ------------------------------------------------------- foreground

    def _cmd_insert_rounds(self, p: dict) -> dict:
        n_acc, rej_v, rej_i, rej_t = self.drv._insert_rounds(
            np.asarray(p["vecs"], np.float32),
            np.asarray(p["ids"], np.int32))
        return {"accepted": int(n_acc),
                "rej_vecs": rej_v, "rej_ids": rej_i, "rej_targets": rej_t}

    def _cmd_cache_put(self, p: dict) -> dict:
        tg = p.get("targets")
        n = self.drv._cache_put(np.asarray(p["vecs"], np.float32),
                                np.asarray(p["ids"], np.int32),
                                targets=tg)
        return {"cached": int(n)}

    def _cmd_delete(self, p: dict) -> dict:
        r = self.drv.delete(np.asarray(p["ids"], np.int64))
        return {"deleted": int(r.deleted)}

    def _cmd_search(self, p: dict) -> dict:
        r = self.drv.search(np.asarray(p["queries"], np.float32),
                            int(p["k"]), p.get("nprobe"))
        return {"ids": _np(r.ids), "scores": _np(r.scores)}

    def _cmd_exact(self, p: dict) -> dict:
        r = self.drv.exact(np.asarray(p["queries"], np.float32),
                           int(p["k"]))
        return {"ids": _np(r.ids), "scores": _np(r.scores)}

    # -------------------------------------------------------- tick legs

    def _cmd_tick_begin(self, p: dict) -> dict:
        executed, reclaimed, press = self.drv.exec_background()
        return {"executed": int(executed), "gc": int(reclaimed),
                "pressure": _np(press)}

    def _cmd_plan_inputs(self, p: dict) -> dict:
        lengths, movable = self.drv.rebalance_inputs()
        return {"lengths": _np(lengths), "movable": _np(movable)}

    def _cmd_tick_exec(self, p: dict) -> dict:
        drv = self.drv
        src = np.asarray(p.get("src", []), np.int32)
        dst = np.asarray(p.get("dst", []), np.int32)
        mig = (drv.exec_migrate(src, dst) if len(src)
               else np.zeros(0, bool))
        drained = drv.exec_drain()
        retrained = drv.exec_pq_retrain() if p.get("retrain") else 0
        rows = None
        if drv.tier is not None:
            # decayed=True: the sharded background round ran in leg 1
            _, rows = drv.tier.observe(drv.state, decayed=True)
            self._replicate()
            self._tier_rows = rows
        return {"migrated": np.asarray(_np(mig), bool),
                "drained": int(drained), "retrained": int(retrained),
                "tier_rows": rows,
                "commits": (drv.tier.drain_commits()
                            if drv.tier is not None else [])}

    def _cmd_tick_end(self, p: dict) -> dict:
        drv = self.drv
        n_s = n_p = 0
        commits: list = []
        if drv.tier is not None:
            rows = self._tier_rows
            if rows is None:
                raise protocol.ProtocolError("tick_end before tick_exec")
            self._tier_rows = None
            _, plan = drv.tier.dispatch_planned(
                drv.state, rows,
                np.asarray(p.get("promotes", []), np.int64),
                np.asarray(p.get("spills", []), np.int64))
            self._replicate()
            _, n_s, n_p = drv.tier.reconcile(drv.state, plan)
            self._replicate()
            drv.stats["tier_spilled"] += n_s
            drv.stats["tier_promoted"] += n_p
            drv.stats["tier_resident"] = len(drv.tier.pool)
            commits = drv.tier.drain_commits()
        return {"spilled": int(n_s), "promoted": int(n_p),
                "commits": commits,
                "cache_backlog": int(drv.state.cache_valid.sum()),
                "tier_resident": (len(drv.tier.pool)
                                  if drv.tier is not None else 0),
                "live": int(drv.live_count())}

    # ------------------------------------------------------------- tier

    def _cmd_force_spill(self, p: dict) -> dict:
        moved = self.drv.force_spill(int(p["n"]))
        tier = self.drv.tier
        return {"moved": int(moved),
                "commits": tier.drain_commits() if tier is not None else [],
                "tier_resident": len(tier.pool) if tier is not None else 0}

    def _cmd_force_promote(self, p: dict) -> dict:
        n = p.get("n")
        moved = self.drv.force_promote(None if n is None else int(n))
        tier = self.drv.tier
        return {"moved": int(moved),
                "commits": tier.drain_commits() if tier is not None else [],
                "tier_resident": len(tier.pool) if tier is not None else 0}

    # ------------------------------------------------------------ state

    def _cmd_snapshot(self, p: dict) -> dict:
        payload = protocol.state_to_payload(self.drv.snapshot())
        return {"state": payload,
                "digest": protocol.live_multiset_digest(payload)}

    def _cmd_load_state(self, p: dict) -> dict:
        self.drv.load_snapshot(protocol.payload_to_state(
            p["state"], self.drv.device))
        self._tier_rows = None
        return {"ok": True, "live": int(self.drv.live_count())}

    def _cmd_live_count(self, p: dict) -> dict:
        return {"live": int(self.drv.live_count())}

    def _cmd_posting_lengths(self, p: dict) -> dict:
        return {"lengths": np.asarray(_np(self.drv.posting_lengths()))}

    def _cmd_occupancy(self, p: dict) -> dict:
        return {"occ": np.asarray(_np(self.drv.shard_occupancy())),
                "live": int(self.drv.live_count())}

    def _cmd_memory(self, p: dict) -> dict:
        tiers = self.drv.memory_tiers()
        return {"bytes": int(self.drv.memory_bytes()),
                "tiers": {k: int(v) for k, v in tiers.items()}}

    def _cmd_stats(self, p: dict) -> dict:
        return {"stats": {k: float(self.drv.stats[k])
                          for k in self.drv.stats}}

    def _cmd_extract(self, p: dict) -> dict:
        """Cross-worker balance donor: hand over up to ``n`` live vectors
        from this worker's longest float-resident NORMAL postings (ids +
        float32 vectors), deleting them locally.  The coordinator
        re-inserts them on the receiving worker: together one logical
        migration, so the live multiset is conserved."""
        from ..core import version_manager as vm
        from ..core.types import STATUS_NORMAL
        drv = self.drv
        want = int(p["n"])
        st = drv.state
        status = vm.unpack_status(st.rec_meta).cpu().numpy()
        ok = (vm.visible(st.rec_meta, st.allocated,
                         st.global_version).cpu().numpy()
              & (status == STATUS_NORMAL)
              & ~st.tier_spilled.cpu().numpy())
        lengths = st.lengths.cpu().numpy()
        order = np.flatnonzero(ok)
        order = order[np.argsort(-lengths[order], kind="stable")]
        sv = st.slot_valid.cpu().numpy()
        picks = []
        got = 0
        for pid in order:
            if got >= want:
                break
            slots = np.flatnonzero(sv[pid])[:want - got]
            if slots.size == 0:
                continue
            picks.append((int(pid), slots))
            got += slots.size
        if not got:
            return {"ids": np.empty(0, np.int32),
                    "vecs": np.empty((0, drv.cfg.dim), np.float32)}
        # the picked postings' rows, read on the shards that own them
        import torch
        pids = torch.tensor([p for p, _ in picks], dtype=torch.int64)
        id_rows = st.get_rows("ids", pids).cpu().numpy()
        vec_rows = st.get_rows("vectors", pids).float().cpu().numpy()
        ids = np.concatenate([id_rows[j][slots] for j, (_, slots)
                              in enumerate(picks)]).astype(np.int32)
        vecs = np.concatenate([vec_rows[j][slots] for j, (_, slots)
                               in enumerate(picks)])
        r = drv.delete(ids)
        if int(r.deleted) != len(ids):
            # tombstoning raced something structural: hand over only what
            # actually left this worker (never duplicate a vector)
            raise protocol.ProtocolError(
                f"extract deleted {r.deleted} of {len(ids)} planned ids")
        return {"ids": ids, "vecs": vecs}


def serve(inp, out, devices: int = 1) -> None:
    """Frame loop: one reply frame per command frame.  Errors reply as
    ``kind="error"`` (the coordinator raises); only a transport-level
    failure ends the loop."""
    rt = WorkerRuntime(devices)
    while True:
        buf = protocol.read_frame(inp)
        if buf is None:
            break
        msg = protocol.decode_message(buf)
        try:
            payload = rt.handle(msg["kind"], msg["payload"])
            reply = protocol.encode_message("ok", payload, msg["seq"])
        except Exception as e:  # noqa: BLE001 - ship the failure up
            reply = protocol.encode_message(
                "error", {"command": msg["kind"], "error": repr(e)},
                msg["seq"])
        protocol.write_frame(out, reply)
        if msg["kind"] == "shutdown":
            break


def main(argv=None) -> None:
    import os
    import sys
    # claim the frame stream before anything can print to it: keep a
    # private handle on the real stdout, then point fd 1 at stderr so
    # stray prints (ours or a library's) never corrupt a frame
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    inp = os.fdopen(os.dup(0), "rb")
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.cluster.worker")
    ap.add_argument("--devices", type=int, default=1,
                    help="logical shards of the default mesh")
    args = ap.parse_args(argv)
    serve(inp, out, args.devices)


if __name__ == "__main__":
    main()
