"""roofline_table: the 40-cell baseline table from the dry-run sweep (port
of ``benchmarks/roofline_table.py``).

Reads ``dryrun_baseline.jsonl`` from the port workspace's ``bench/``
directory (written by ``python -m repro_torch.launch.dryrun --all --mesh
both --out <workspace>/bench/dryrun_baseline.jsonl``) and reports per
(arch × shape × mesh) the three roofline terms per device, the dominant
one, the MODEL_FLOPS ratio and the HBM fit.  The terms are the dry run's
analytical figures on its machine's datasheet spec (``h100-sxm`` by
default), not measurements.  Without the file the one row is
``roofline_table/missing_sweep``.

Run: ``python -m repro_torch.bench --only roofline_table``.
"""

from __future__ import annotations

import json
import os

import torch

from repro_torch.bench.common import Row

FILENAME = "dryrun_baseline.jsonl"


def results_path() -> str:
    from repro_torch.session.workspace import Workspace
    return os.path.join(Workspace().bench_dir, FILENAME)


def load(path: str | None = None) -> list[dict]:
    path = path or results_path()
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def rows_of(recs: list[dict]) -> list[Row]:
    """The table's rows of dry-run records (failed cells left out)."""
    recs = [r for r in recs if not r.get("error")]
    rows: list[Row] = []
    if not recs:
        rows.append(("roofline_table/missing_sweep", 0.0,
                     "run repro_torch.launch.dryrun --all first"))
        return rows
    for r in recs:
        name = f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}"
        coll = r["collective_ici_s"] + r["collective_dcn_s"]
        rows.append((name, 0.0,
                     f"compute={r['compute_s']*1e3:.1f}ms;"
                     f"memory={r['memory_s']*1e3:.1f}ms;"
                     f"coll={coll*1e3:.1f}ms;"
                     f"dom={r['dominant']};"
                     f"frac={r['roofline_fraction']:.3f};"
                     f"mfr={r['model_flops_ratio']:.3f};"
                     f"fits={r['fits_hbm']}"))
    n_fit = sum(1 for r in recs if r["fits_hbm"])
    rows.append(("roofline_table/cells", 0.0, str(len(recs))))
    rows.append(("roofline_table/fit_cells", 0.0, f"{n_fit}/{len(recs)}"))
    doms: dict[str, int] = {}
    for r in recs:
        doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    rows.append(("roofline_table/dominant_histogram", 0.0,
                 ";".join(f"{k}={v}" for k, v in sorted(doms.items()))))
    return rows


def main(device: str | torch.device = "cuda",
         path: str | None = None) -> list[Row]:
    """The table of the workspace's dry-run file (``path`` instead, if
    given); ``device`` is not read: the table is analytical."""
    return rows_of(load(path))
