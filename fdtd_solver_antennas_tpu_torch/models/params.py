"""Parameter models for the patch antenna (SI internals, mm/GHz constructors).

Counterpart of ``fdtd_solver_antennas_tpu/models/params.py`` as plain
dataclasses: the same field names, the same ``from_user_units``
constructor and the same range checks, which raise ``ValueError``.
``from_dict`` takes what the JAX package's ``model_dump()`` writes, and
``to_dict`` writes the same layout back.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class Metal(str, Enum):
    COPPER = "copper"
    ALUMINUM = "aluminum"
    GOLD = "gold"
    SILVER = "silver"
    TIN = "tin"


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


@dataclass
class MetalProperties:
    name: str
    conductivity_s_per_m: float
    thickness_m: float = 35e-6  # ~1 oz copper

    def __post_init__(self) -> None:
        self.conductivity_s_per_m = float(self.conductivity_s_per_m)
        self.thickness_m = float(self.thickness_m)
        _require(self.conductivity_s_per_m > 0, "conductivity_s_per_m must be > 0")
        _require(self.thickness_m > 0, "thickness_m must be > 0")

    def display(self) -> str:
        ms = self.conductivity_s_per_m / 1e7
        return f"{self.name} (σ≈{ms:.1f}×10^7 S/m, t={self.thickness_m * 1e6:.0f} µm)"


# Conductor property table.
metal_defaults: dict[Metal, MetalProperties] = {
    Metal.COPPER: MetalProperties("Copper", 5.8e7, 35e-6),
    Metal.ALUMINUM: MetalProperties("Aluminum", 3.5e7, 35e-6),
    Metal.GOLD: MetalProperties("Gold", 4.1e7, 2e-6),
    Metal.SILVER: MetalProperties("Silver", 6.3e7, 10e-6),
    Metal.TIN: MetalProperties("Tin", 9.1e6, 5e-6),
}


def _resolve_metal(metal: str, metal_thickness_um: Optional[float]) -> MetalProperties:
    try:
        metal_enum = Metal(metal.lower())
    except ValueError:
        metal_enum = Metal.COPPER
    props = dataclasses.replace(metal_defaults[metal_enum])
    if metal_thickness_um is not None:
        props.thickness_m = max(1e-7, metal_thickness_um * 1e-6)
    return props


@dataclass
class PatchAntennaParams:
    """Rectangular microstrip patch antenna parameters (SI units internally).

    If ``patch_length_m``/``patch_width_m`` are omitted, they are designed
    for TM10 resonance at ``frequency_hz``.
    """

    frequency_hz: float
    eps_r: float
    h_m: float
    loss_tangent: float = 0.0
    metal: MetalProperties = field(
        default_factory=lambda: dataclasses.replace(metal_defaults[Metal.COPPER])
    )
    patch_length_m: Optional[float] = None
    patch_width_m: Optional[float] = None

    def __post_init__(self) -> None:
        self.frequency_hz = float(self.frequency_hz)
        self.eps_r = float(self.eps_r)
        self.h_m = float(self.h_m)
        self.loss_tangent = float(self.loss_tangent)
        _require(self.frequency_hz > 0, "frequency_hz must be > 0")
        _require(self.eps_r > 1, "eps_r must be > 1")
        _require(self.h_m > 0, "h_m must be > 0")
        _require(self.loss_tangent >= 0, "loss_tangent must be >= 0")
        for name in ("patch_length_m", "patch_width_m"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, float(v))
                _require(float(v) > 0, f"{name} must be > 0")

    @classmethod
    def from_user_units(
        cls,
        *,
        frequency_ghz: float,
        er: float,
        h_mm: float,
        L_mm: Optional[float] = None,
        W_mm: Optional[float] = None,
        metal: str = "copper",
        loss_tangent: float = 0.0,
        metal_thickness_um: Optional[float] = None,
    ) -> "PatchAntennaParams":
        return cls(
            frequency_hz=frequency_ghz * 1e9,
            eps_r=er,
            h_m=h_mm * 1e-3,
            patch_length_m=None if L_mm is None else L_mm * 1e-3,
            patch_width_m=None if W_mm is None else W_mm * 1e-3,
            metal=_resolve_metal(metal, metal_thickness_um),
            loss_tangent=loss_tangent,
        )

    @classmethod
    def from_dict(cls, d: dict) -> "PatchAntennaParams":
        """Build from the JAX package's ``PatchAntennaParams.model_dump()``."""
        d = dict(d)
        metal = d.pop("metal", None)
        if isinstance(metal, dict):
            metal = MetalProperties(**metal)
        if metal is not None:
            d["metal"] = metal
        return cls(**d)

    def to_dict(self) -> dict:
        """The ``model_dump()`` layout: plain fields, ``metal`` nested."""
        return dataclasses.asdict(self)

    @property
    def frequency_ghz(self) -> float:
        return self.frequency_hz / 1e9

    @property
    def h_mm(self) -> float:
        return self.h_m * 1e3

    @property
    def L_mm(self) -> Optional[float]:
        return None if self.patch_length_m is None else self.patch_length_m * 1e3

    @property
    def W_mm(self) -> Optional[float]:
        return None if self.patch_width_m is None else self.patch_width_m * 1e3
