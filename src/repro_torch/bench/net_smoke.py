"""net_smoke: the interconnect level end to end, in miniature (port of
``benchmarks/net_smoke.py``).

Against a throwaway workspace:

1. **characterize** — collective microbenchmarks on 8 gloo ranks on the
   host's CPU (the reference's 8 forced host devices) store measured ICI
   / DCN ceilings under ``cpu-host`` in the workspace tune store; a
   second characterize is a store hit that times nothing;
2. **attribute** — a sharded sweep point's stored record carries the net
   level: nonzero collective bounds in its phase payloads and the
   measured ceilings' provenance in ``meta.net_ceilings``;
3. **campaign** — a two-shape ``mesh_shapes`` sweep ranked by the net
   report, which finds the network-bound point and the flip.

The ceilings are the host's loopback under ``cpu-host``, never a card's:
NCCL needs a card a rank.  Whatever ``device`` says, the suite runs on
the host (the sweep is analytical, on meta tensors).

Run: ``python -m repro_torch.bench --only net_smoke [--device cpu]``.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from repro_torch.bench.common import Row

CONFIG = "minitron-4b"
MESHES = ("1x1", "1x8")


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.session.session import Session
    from repro_torch.session.workspace import WORKSPACE_ENV, Workspace
    from repro_torch.sweep.aggregate import latest_per_point, sweep_records

    rows: list[Row] = []
    prev = os.environ.get(WORKSPACE_ENV)
    with tempfile.TemporaryDirectory() as d:
        # pin the workspace for this process and the sweep's workers, so
        # the engine resolves the tune store the ceilings landed in
        os.environ[WORKSPACE_ENV] = d
        try:
            ws = Workspace(d)
            s = Session(machine="cpu-host", device=device, workspace=ws)

            # 1. characterize: measured, then a store hit
            t0 = time.time()
            r = s.net_characterize(n_devices=8, smoke=True, iters=2)
            t_cold = time.time() - t0
            assert r.data["cached"] is False
            ceil = r.data["ceilings"]
            assert set(ceil) == {"ici", "dcn"}
            assert all(c["bytes_per_s"] > 0 for c in ceil.values())
            rows.append(("net_smoke/characterize", t_cold * 1e6,
                         f"ici={ceil['ici']['bytes_per_s'] / 1e9:.3f}GB/s;"
                         f"dcn={ceil['dcn']['bytes_per_s'] / 1e9:.3f}GB/s"))
            t0 = time.time()
            r2 = s.net_characterize(n_devices=8, smoke=True, iters=2)
            t_warm = time.time() - t0
            assert r2.data["cached"] is True, \
                "second characterize must be a store hit"
            assert t_warm < t_cold, (t_warm, t_cold)
            rows.append(("net_smoke/store_hit", t_warm * 1e6,
                         "zero re-timing"))

            # 3. campaign: two mesh shapes, analytical bounds
            t0 = time.time()
            sw = s.sweep(name="net-smoke", configs=(CONFIG,),
                         seqs=(32,), batches=(4,), amps=("O1",),
                         mesh_shapes=MESHES, measure=False)
            t_sweep = time.time() - t0
            assert sw.exit_code == 0, sw.text
            assert sw.data.n_ok == len(MESHES), sw.text
            rows.append(("net_smoke/mesh_sweep", t_sweep * 1e6,
                         f"points={sw.data.n_ok}"))

            # 2. attribute: the sharded record carries the net level with
            # the measured ceilings' provenance
            recs = latest_per_point(sweep_records(ws.sweep_store,
                                                  "net-smoke"))
            assert len(recs) == len(MESHES)
            big = next(r for r in recs.values()
                       if r.mesh.get("model") == 8)
            net = sum(float(p.get("ici_bound_s", 0.0))
                      + float(p.get("dcn_bound_s", 0.0))
                      for p in big.phases.values())
            mem = sum(float(p.get("memory_s", 0.0))
                      for p in big.phases.values())
            comp = sum(float(p.get("compute_s", 0.0))
                       for p in big.phases.values())
            assert net > 0, "a sharded point must carry collective bounds"
            assert sum(float(p.get("net_bytes", 0.0))
                       for p in big.phases.values()) > 0
            prov = big.meta.get("net_ceilings")
            assert prov and set(prov) == {"ici", "dcn"}, \
                "the measured ceilings' provenance must ride in the record"
            assert prov["ici"]["n_devices"] == 8
            frac = net / max(net, mem, comp)
            assert frac > 0
            rows.append(("net_smoke/net_frac_1x8", net * 1e6,
                         f"net_frac={frac:.2f}"))

            # the report ranks the shapes and finds the network-bound one
            rep = s.net_report(sweep="net-smoke")
            assert rep.exit_code == 0, rep.text
            assert "mesh-scale ranking" in rep.text
            assert "measured" in rep.text, "ceilings must cite provenance"
            bound = {r_["mesh"].get("model", 1): r_["bound"]
                     for r_ in rep.data}
            assert bound[8] == "net", \
                f"the 1x8 point must be network-bound, got {bound}"
            assert "network-bound" in rep.text, rep.text
            rows.append(("net_smoke/report", 0.0,
                         f"bound@1x8={bound[8]};bound@1x1={bound[1]}"))
        finally:
            if prev is None:
                os.environ.pop(WORKSPACE_ENV, None)
            else:
                os.environ[WORKSPACE_ENV] = prev
    return rows

