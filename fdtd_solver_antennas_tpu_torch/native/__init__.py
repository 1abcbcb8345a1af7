"""The native (C++) voxelizer core, built with g++ and loaded with ctypes."""

from .build import get_voxelize_lib, native_available

__all__ = ["get_voxelize_lib", "native_available"]
