"""Machine model for the roofline (port of ``repro.core.machine``).

A :class:`MachineSpec` holds one compute ceiling per precision class and
one bandwidth per memory level, ordered fastest to slowest.  On Hopper
the levels are ``l2`` then ``hbm``: ``mem_levels[0]`` is the on-chip level
the reference calls ``vmem`` (its ``vmem`` property keeps that name), and
``mem_levels[-1]`` is device memory.

Two sources fill a spec: the datasheet (``empirical=False``, picked by
the name ``torch.cuda.get_device_name()`` reports) and the ERT kernels in
``repro_torch.kernels.ert`` (``with_empirical``).

The interconnect keeps the reference's level names so that records keep
their schema keys (``ici_bytes``, ``dcn_bytes``): on an H100 ``ici`` is
NVLink inside the node and ``dcn`` the network between nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class MemLevel:
    """One level of the memory hierarchy (paper: L1/L2/HBM)."""

    name: str
    bytes_per_s: float          # sustained bandwidth, bytes/s per device
    capacity_bytes: int | None  # None = not capacity-limited


@dataclasses.dataclass(frozen=True)
class NetLevel:
    """One level of the interconnect hierarchy."""

    name: str                   # "ici" | "dcn"
    bytes_per_s: float          # aggregate wire bandwidth, bytes/s per device
    latency_s: float = 0.0      # per-collective latency


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Per-device machine model with multi-precision ceilings (paper Fig 1)."""

    name: str
    peak_flops: Mapping[str, float]
    mem_levels: tuple[MemLevel, ...]     # fastest → slowest
    ici_bytes_per_s: float
    ici_links: int
    dcn_bytes_per_s: float
    empirical: bool = False
    net_levels: tuple[NetLevel, ...] = ()

    @property
    def hbm(self) -> MemLevel:
        return self.mem_levels[-1]

    @property
    def vmem(self) -> MemLevel:
        """The on-chip level (``l2`` on Hopper, ``vmem`` on the TPU)."""
        return self.mem_levels[0]

    @property
    def interconnect(self) -> tuple[NetLevel, ...]:
        if self.net_levels:
            return self.net_levels
        return (NetLevel("ici", self.ici_bytes_per_s * self.ici_links),
                NetLevel("dcn", self.dcn_bytes_per_s))

    def net_level(self, name: str) -> NetLevel:
        for lv in self.interconnect:
            if lv.name == name:
                return lv
        raise KeyError(f"no interconnect level {name!r} in {self.name}")

    def peak_for(self, dtype_class: str) -> float:
        """Ceiling for a dtype class, defaulting to the bf16 ceiling."""
        return self.peak_flops.get(dtype_class, self.peak_flops["bf16"])

    def ridge_point(self, dtype_class: str = "bf16", level: str = "hbm") -> float:
        """AI (FLOPs/byte) where the machine turns from memory- to compute-bound."""
        bw = self.hbm.bytes_per_s if level == "hbm" else self.level(level).bytes_per_s
        return self.peak_for(dtype_class) / bw

    def level(self, name: str) -> MemLevel:
        for lv in self.mem_levels:
            if lv.name == name:
                return lv
        raise KeyError(f"no memory level {name!r} in {self.name}")

    def with_empirical(self, peaks: Mapping[str, float] | None = None,
                       bandwidths: Mapping[str, float] | None = None
                       ) -> "MachineSpec":
        """Overwrite datasheet ceilings with ERT measurements."""
        flops = dict(self.peak_flops)
        if peaks:
            flops.update(peaks)
        levels = tuple(
            MemLevel(lv.name, (bandwidths or {}).get(lv.name, lv.bytes_per_s),
                     lv.capacity_bytes)
            for lv in self.mem_levels)
        return dataclasses.replace(self, peak_flops=flops, mem_levels=levels,
                                   empirical=True)


# --------------------------------------------------------------------------
# Datasheet machine models (NVIDIA's H100 data sheet, dense rates)
# --------------------------------------------------------------------------

def _h100(name: str, bf16: float, f32: float, hbm: float,
          hbm_bytes: int, nvlink: float) -> MachineSpec:
    return MachineSpec(
        name=name,
        # int8/fp8 run at twice the bf16 tensor-core rate
        peak_flops={"bf16": bf16, "f32": f32, "int8": 2 * bf16},
        mem_levels=(
            # L2 bandwidth: a modeled placeholder (about 3x HBM), not a
            # datasheet figure; ERT's L2-resident triad overwrites it
            MemLevel("l2", 3 * hbm, 50 * 10**6),
            MemLevel("hbm", hbm, hbm_bytes),
        ),
        # NVLink per direction inside the node; one 400 Gb/s NIC per card
        ici_bytes_per_s=nvlink, ici_links=1, dcn_bytes_per_s=50e9)


H100_SXM = _h100("h100-sxm", 989e12, 67e12, 3.35e12, 80 * 10**9, 450e9)
H100_PCIE = _h100("h100-pcie", 756e12, 51e12, 2.0e12, 80 * 10**9, 300e9)
H100_NVL = _h100("h100-nvl", 835e12, 60e12, 3.9e12, 94 * 10**9, 300e9)

# Host CPU — placeholder; ``characterize(device="cpu")`` measures it
CPU_HOST = MachineSpec(
    name="cpu-host",
    peak_flops={"bf16": 100e9, "f32": 100e9, "int8": 100e9},
    mem_levels=(
        MemLevel("vmem", 200e9, 32 * 2**20),     # stands in for LLC
        MemLevel("hbm", 20e9, None),             # stands in for DRAM
    ),
    ici_bytes_per_s=10e9,
    ici_links=1,
    dcn_bytes_per_s=10e9,
)

MACHINES: dict[str, MachineSpec] = {
    m.name: m for m in (H100_SXM, H100_PCIE, H100_NVL, CPU_HOST)
}


def get_machine(name: str = "h100-sxm") -> MachineSpec:
    try:
        return MACHINES[name]
    except KeyError:
        raise KeyError(f"unknown machine {name!r}; known: {sorted(MACHINES)}")


def datasheet_for(device_name: str) -> MachineSpec:
    """Datasheet spec for a card, by the name ``get_device_name`` reports."""
    low = device_name.lower()
    if "h100" in low:
        if "pcie" in low:
            return H100_PCIE
        if "nvl" in low:
            return H100_NVL
        return H100_SXM
    raise KeyError(f"no datasheet spec for {device_name!r}; known: "
                   f"{sorted(MACHINES)}")
