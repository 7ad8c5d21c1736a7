"""Multi-position 2D 5-point stencil: halo exchange over the device mesh.

The port of :mod:`parsec_tpu.parallel.stencil_spmd`.  The grid is
block-sharded over a ``(p, q)`` mesh; each position owns an ``(H/p, W/q)``
block and exchanges one halo row/column per side per iteration, one
:func:`~.shard_map.ppermute` a direction.  Edge positions receive their own
sent row/column, masked to zero: zero (Dirichlet) boundaries, as in
:func:`parsec_tpu_torch.ops.stencil.reference_stencil`.  The step is plain
array code, as in the reference (no hand kernel on this path).
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import Mesh
from .shard_map import P, as_tensor, axis_index, ppermute, shard_map

__all__ = ["spmd_stencil_5pt"]


def spmd_stencil_5pt(grid, iters: int, mesh: Mesh,
                     axes: Optional[tuple] = None) -> torch.Tensor:
    """Run ``iters`` Jacobi 5-point steps on a grid block-sharded over
    ``mesh``; returns the final grid on the mesh's first device."""
    grid = as_tensor(grid)
    ax_r, ax_c = axes if axes is not None else mesh.axis_names[:2]
    p, q = mesh.shape[ax_r], mesh.shape[ax_c]
    H, W = grid.shape
    if H % p or W % q:
        raise ValueError(f"grid {tuple(grid.shape)} does not split over the {p}x{q} mesh")
    up_perm = [(i, (i + 1) % p) for i in range(p)]      # send down
    down_perm = [(i, (i - 1) % p) for i in range(p)]    # send up
    left_perm = [(i, (i + 1) % q) for i in range(q)]
    right_perm = [(i, (i - 1) % q) for i in range(q)]

    def kernel(g):
        # g: the local (H/p, W/q) block
        ri, ci = axis_index(ax_r), axis_index(ax_c)
        h, w = g.shape
        zr = torch.zeros((1, w), dtype=g.dtype, device=g.device)
        zc = torch.zeros((h, 1), dtype=g.dtype, device=g.device)
        cur = g
        for _ in range(iters):
            from_up = ppermute(cur[-1:, :], ax_r, up_perm)      # row above mine
            from_down = ppermute(cur[:1, :], ax_r, down_perm)   # row below mine
            from_left = ppermute(cur[:, -1:], ax_c, left_perm)  # col left of mine
            from_right = ppermute(cur[:, :1], ax_c, right_perm)  # col right of mine
            from_up = zr if ri == 0 else from_up
            from_down = zr if ri == p - 1 else from_down
            from_left = zc if ci == 0 else from_left
            from_right = zc if ci == q - 1 else from_right

            up = torch.cat([from_up, cur[:-1, :]], dim=0)
            down = torch.cat([cur[1:, :], from_down], dim=0)
            left = torch.cat([from_left, cur[:, :-1]], dim=1)
            right = torch.cat([cur[:, 1:], from_right], dim=1)
            cur = 0.25 * (up + down + left + right)
        return cur

    spec = P(ax_r, ax_c)
    return shard_map(kernel, mesh, (spec,), spec)(grid)
