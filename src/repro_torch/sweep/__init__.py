"""Cross-config roofline campaigns (port of ``repro.sweep``).

A declarative :class:`~repro_torch.sweep.spec.SweepSpec` (configs × mesh
shapes × AMP policies × batches × fusion modes) expands into a work list;
a supervised pool of spawned workers runs the analytical op walk on meta
tensors — and, for measured points, the same phases timed on the card —
for every point; each result lands in the trace-schema sweep store, and
the report side ranks achieved against bound across configs and draws a
roofline gallery (the batch workflow of arXiv 2009.04598 and
arXiv 2009.02449).

* :mod:`repro_torch.sweep.spec`      — SweepSpec / SweepPoint, expansion,
  presets
* :mod:`repro_torch.sweep.engine`    — worker pools, the journal,
  resume, the analysis cache, the store
* :mod:`repro_torch.sweep.aggregate` — ranked summary, gallery, tune
  provenance
* :mod:`repro_torch.sweep.cli`       — ``python -m repro_torch sweep``
  run / report
"""

from repro_torch.sweep.spec import (  # noqa: F401
    SweepPoint, SweepSpec, invalid_reason, parse_mesh, points_by_devices,
    smoke_spec,
)
