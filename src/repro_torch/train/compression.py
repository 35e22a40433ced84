"""Radix gradient compression (port of ``repro/train/compression.py``):
the paper's encoding reused on gradients.

Each block of ``block`` gradient values maps to a sign bit and a T-bit
level against the block's max-abs scale, rounded stochastically
(``floor(x + u)``, ``u ~ U[0, 1)``, so the quantizer is unbiased); an
error-feedback accumulator carries each step's residual into the next.
Where the reference takes a PRNG key, :func:`compress` takes a
``torch.Generator``; :func:`quantize` is the rest of it, given the
uniform draws, so a test can feed it the reference's.  Every division by
the level count divides by a float32 tensor on the gradient's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import encoding
from repro_torch.train.tree import leaves, tree_map, unflatten

__all__ = ["RadixCompressor", "compress", "quantize", "decompress",
           "wire_bytes"]

F32 = torch.float32


def _blockwise(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    return F.pad(flat, (0, pad)).reshape(-1, block), pad


def _levels(num_steps: int, device) -> torch.Tensor:
    return torch.tensor(float(encoding.max_level(num_steps)), dtype=F32,
                        device=device)


def quantize(g: torch.Tensor, num_steps: int, block: int, u: torch.Tensor):
    """:func:`compress` given its uniform draws ``u`` ((blocks, block)
    float32 in [0, 1))."""
    blocks, pad = _blockwise(g.to(F32), block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) + 1e-12
    lvl = encoding.max_level(num_steps)
    mag = torch.abs(blocks) / scale * lvl
    q = torch.clamp(torch.floor(mag + u), 0, lvl).to(torch.uint8)
    sign = (blocks < 0).to(torch.uint8)
    return (sign, q, scale.squeeze(1)), (tuple(g.shape), pad)


def compress(g: torch.Tensor, num_steps: int, block: int,
             generator: Optional[torch.Generator] = None):
    """float grad -> ((sign uint8, level uint8, per-block scale f32),
    (shape, pad)).  The sign is one bit on the wire (``wire_bytes``)."""
    n = g.numel()
    u = torch.rand(((n + block - 1) // block, block), generator=generator,
                   dtype=F32, device=g.device)
    return quantize(g, num_steps, block, u)


def decompress(payload, meta, num_steps: int) -> torch.Tensor:
    (sign, q, scale), (shape, pad) = payload, meta
    vals = q.to(F32) / _levels(num_steps, q.device) * scale[:, None]
    vals = torch.where(sign == 1, -vals, vals).reshape(-1)
    if pad:
        vals = vals[:-pad]
    return vals.reshape(shape)


def wire_bytes(numel: int, num_steps: int, block: int) -> int:
    """Bytes on the link per tensor: (1 sign + T magnitude) bits a value,
    plus one f32 scale per block."""
    bits = numel * (1 + num_steps)
    return bits // 8 + (numel + block - 1) // block * 4


@dataclasses.dataclass
class RadixCompressor:
    """Error-feedback compressed gradient exchange::

        comp = RadixCompressor(num_steps=4, block=256)
        ef = comp.init(params)
        grads, ef = comp.roundtrip(grads, ef, generator)
    """

    num_steps: int = 4
    block: int = 256

    def init(self, params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                              device=p.device), params)

    def roundtrip(self, grads, ef, generator: Optional[torch.Generator] = None):
        """Compress (with error feedback) and decompress: what the
        receivers see.  Returns (decompressed grads, new accumulator)."""
        out, new_ef = [], []
        for g, e in zip(leaves(grads), leaves(ef)):
            target = g.to(F32) + e
            payload, meta = compress(target, self.num_steps, self.block,
                                     generator)
            recon = decompress(payload, meta, self.num_steps)
            out.append(recon.to(g.dtype))
            new_ef.append(target - recon)
        return unflatten(grads, out), unflatten(grads, new_ef)

    def compression_ratio(self, dtype_bits: int = 32) -> float:
        return dtype_bits / (1 + self.num_steps + 32 / self.block)
