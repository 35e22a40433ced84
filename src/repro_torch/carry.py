"""Carry float params and converted nets across from the JAX package.

Both take plain numpy arrays (``np.asarray`` of the JAX arrays), so this
module needs neither JAX nor ``repro``.  The parity tests run the two
packages on the same converted net this way.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.conversion import QuantizedNet
from repro_torch.core.encoding import RadixEncoding

__all__ = ["float_params_from_numpy", "qnet_from_numpy", "qnet_to_numpy"]


def float_params_from_numpy(params) -> List[Optional[dict]]:
    """The reference's float ``params`` list (``{"w", "b"}`` or ``None``
    per layer) as float32 CPU tensors."""
    return [None if p is None else
            {k: torch.from_numpy(np.array(p[k], dtype=np.float32))
             for k in ("w", "b")}
            for p in params]


def _tensor(a, dtype):
    return None if a is None else torch.from_numpy(np.array(a, dtype=dtype))


def qnet_from_numpy(static, qlayers, *, num_steps: int, weight_bits: int,
                    input_scale: float, logit_scale,
                    encoding: str = "radix") -> QuantizedNet:
    """A converted net's fields as numpy (``w_q``, ``b_int``, ``mult`` per
    conv/linear layer, ``None`` for the others) -> the port's
    :class:`QuantizedNet` on the CPU."""
    if encoding != "radix":
        raise ValueError(f"encoding {encoding!r} is not ported yet; only "
                         "'radix' carries across")
    layers = [None if qp is None else {
        "w_q": _tensor(qp["w_q"], np.int8),
        "b_int": _tensor(qp["b_int"], np.int32),
        "mult": _tensor(qp["mult"], np.float32),
    } for qp in qlayers]
    if np.ndim(logit_scale) == 0:
        logit_scale = float(logit_scale)
    else:
        logit_scale = _tensor(logit_scale, np.float32)
    return QuantizedNet(static=tuple(static), num_steps=int(num_steps),
                        weight_bits=int(weight_bits), qlayers=layers,
                        input_scale=float(input_scale),
                        logit_scale=logit_scale,
                        encoding=RadixEncoding(int(num_steps)))


def qnet_to_numpy(qnet: QuantizedNet) -> dict:
    """The inverse of :func:`qnet_from_numpy`: keyword fields as numpy."""
    def arr(t):
        return None if t is None else t.detach().cpu().numpy()

    ls = qnet.logit_scale
    return dict(
        static=qnet.static,
        qlayers=[None if qp is None else {k: arr(qp[k]) for k in
                                          ("w_q", "b_int", "mult")}
                 for qp in qnet.qlayers],
        num_steps=qnet.num_steps,
        weight_bits=qnet.weight_bits,
        input_scale=qnet.input_scale,
        logit_scale=arr(ls) if torch.is_tensor(ls) else ls,
        encoding=qnet.spec.name,
    )
