"""Ex10 — long-context sequence parallelism: ring attention and Ulysses
over a device mesh.

No reference analog (PaRSEC predates ring attention) — this is the
framework's first-class long-context support: one logical sequence is
sharded across a ring of mesh positions; ring attention rotates K/V
blocks with ``ppermute`` while accumulating an online softmax, Ulysses
reshards seq→head with ``all_to_all`` and runs dense attention.  A mesh is
one process driving its positions, a thread a position
(:mod:`parsec_tpu_torch.parallel`); here all eight positions sit on the
one card (or on the torch CPU device), and both must match a
single-device oracle.  On the card the ring runs once more with
``use_kernels=True``: each step one batched launch of the hand-written
``flash_attention_block`` kernel (B5) over the B·H planes, R² launches in
all, held within the same 1e-4 of the oracle and of the einsum ring.
"""

import sys

import numpy as np
import torch

from parsec_tpu_torch.dsl.cuda_graph import resolve_device
from parsec_tpu_torch.parallel import (
    attention_reference,
    make_mesh,
    ring_attention,
    ulysses_attention,
)


def main(device=None, *, positions: int = 8, batch: int = 2, seq_per_position: int = 16,
         heads: int = 8, head_dim: int = 32, use_kernels=None) -> dict:
    dev = resolve_device(device, "ex10")
    use_kernels = dev.type == "cuda" if use_kernels is None else use_kernels
    R = positions
    mesh = make_mesh((R, 1), axes=("sp", "unused"), devices=[dev] * R)
    B, S, H, D = batch, seq_per_position * R, heads, head_dim
    rng = np.random.default_rng(0)

    def mk():
        return torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32)).to(dev)

    q, k, v = mk(), mk(), mk()

    ref = attention_reference(q, k, v, causal=True)
    ring = ring_attention(q, k, v, mesh, axis="sp", causal=True)
    uly = ulysses_attention(q, k, v, mesh, axis="sp", causal=True)

    err_r = (ring - ref).abs().max().item()
    err_u = (uly - ref).abs().max().item()
    assert err_r < 1e-4 and err_u < 1e-4, (err_r, err_u)
    print(f"ex10 sequence-parallel: seq {S} over {R}-position ring, "
          f"ring err {err_r:.1e}, ulysses err {err_u:.1e}: OK")
    out = {"q": q, "k": k, "v": v, "ref": ref, "ring": ring, "ulysses": uly,
           "ring_err": err_r, "ulysses_err": err_u}
    if use_kernels:
        ring_k = ring_attention(q, k, v, mesh, axis="sp", causal=True, use_kernels=True)
        err_k = (ring_k - ref).abs().max().item()
        diff = (ring_k - ring).abs().max().item()
        assert err_k < 1e-4 and diff < 1e-4, (err_k, diff)
        print(f"ex10 ring with the B5 kernel: {R * R} batched launches of {B * H} "
              f"planes, err {err_k:.1e}, against the einsum ring {diff:.1e}: OK")
        out.update(ring_kernels=ring_k, ring_kernels_err=err_k, ring_kernels_diff=diff)
    return out


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
