from .params import (
    HornAntennaParams,
    Metal,
    MetalProperties,
    PatchAntennaParams,
    metal_defaults,
)
from .scene import (
    PEC,
    Box,
    ConvexPolyhedron,
    LumpedPortSpec,
    Material,
    MSLPortSpec,
    NF2FFBoxSpec,
    Scene,
    make_plate,
    rotation_matrix,
)

__all__ = [
    "Metal",
    "MetalProperties",
    "metal_defaults",
    "PatchAntennaParams",
    "HornAntennaParams",
    "Material",
    "PEC",
    "Box",
    "ConvexPolyhedron",
    "make_plate",
    "LumpedPortSpec",
    "MSLPortSpec",
    "NF2FFBoxSpec",
    "Scene",
    "rotation_matrix",
]
