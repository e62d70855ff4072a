"""Config registry: name → (full config, smoke config).

Every config of the reference: the dense ``glm4-9b``, ``granite-8b``,
``minitron-4b`` and ``mistral-large-123b``, the SSM ``mamba2-1.3b``, the
hybrid ``zamba2-1.2b``, the MoE ``granite-moe-1b-a400m`` and
``kimi-k2-1t-a32b``, the VLM ``phi-3-vision-4.2b``, the enc-dec
``seamless-m4t-large-v2`` and the paper's own CNN ``deepcam`` (which, as
in the reference, is not one of the LM ``ARCHS``: it takes image shapes,
not the LM shape grid).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "minitron-4b": "minitron_4b",
    "mistral-large-123b": "mistral_large_123b",
    "granite-8b": "granite_8b",
    "glm4-9b": "glm4_9b",
    "zamba2-1.2b": "zamba2_1p2b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-1.3b": "mamba2_1p3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepcam": "deepcam",
}

ARCHS = tuple(k for k in _MODULES if k != "deepcam")
ALL = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port knows: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def family_of(name: str) -> str:
    return get_config(name).family


def select(selector: str) -> tuple[str, ...]:
    """Expand one config selector (an entry of a sweep spec's
    ``configs``): ``"all"`` is the LM archs (``ARCHS``),
    ``"family:<fam>"`` every arch of that family, an exact name itself
    (``deepcam`` too)."""
    if selector == "all":
        return ARCHS
    if selector.startswith("family:"):
        fam = selector.removeprefix("family:")
        out = tuple(a for a in ARCHS if family_of(a) == fam)
        if not out:
            raise KeyError(f"no assigned arch has family {fam!r}")
        return out
    if selector not in _MODULES:
        raise KeyError(f"unknown arch {selector!r}; known: {sorted(_MODULES)} "
                       "(or 'all' / 'family:<fam>')")
    return (selector,)


def select_many(selectors) -> tuple[str, ...]:
    """Expand and dedupe a list of selectors, first-seen order kept."""
    seen: dict[str, None] = {}
    for sel in selectors:
        for name in select(sel):
            seen.setdefault(name)
    return tuple(seen)
