"""Peaks of the chip and the bytes each measured kernel must move.

The bytes are worked out from the shapes of the work (the mesh, the texture,
the images), never from the program's own layouts (tile lists, packed bins),
so they read the same whatever implements the kernel: each input byte read
once, each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM (the data sheet), at its full 700 W power limit
H100_HBM_BYTES_PER_S = 3.35e12


def joint_entropy_bytes(S: int, R: int, P: int) -> int:
    """Kernel B1 over one sweep: S renders and R warps of P one-byte bins
    read once, S x R float32 scores (joint entropies) written once."""
    return (S + R) * P + 4 * S * R


def render_gray_bytes(n_vertices: int, n_faces: int, tex_h: int, tex_w: int, S: int, H: int,
                      W: int) -> int:
    """The mesh render of one sweep: float32 vertices (3) and UVs (2), int32
    faces (3) and the float32 texture read once, S float32 gray images of
    H x W written once."""
    return 4 * (5 * n_vertices + 3 * n_faces + tex_h * tex_w + S * H * W)


def roofline_share(total_bytes: float, device_s: float) -> float | None:
    """The least time the bytes need at the HBM peak over the measured
    kernel time, in %; None where the kernel did not run."""
    if device_s <= 0 or total_bytes <= 0:
        return None
    return 100.0 * (total_bytes / H100_HBM_BYTES_PER_S) / device_s
