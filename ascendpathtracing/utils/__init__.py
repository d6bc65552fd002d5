"""Host-side utilities: binary SoA IO, PPM codec, profiling, logging."""

from ascendpathtracing.utils.io import (
    read_color_bin,
    read_rays_bin,
    read_spheres_bin,
    write_color_bin,
    write_rays_bin,
    write_spheres_bin,
    decode_color,
    encode_ppm,
    read_ppm,
    write_ppm,
)

__all__ = [
    "read_color_bin",
    "read_rays_bin",
    "read_spheres_bin",
    "write_color_bin",
    "write_rays_bin",
    "write_spheres_bin",
    "decode_color",
    "encode_ppm",
    "read_ppm",
    "write_ppm",
]
