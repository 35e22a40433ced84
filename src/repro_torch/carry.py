"""Carry float params, converted nets and LM params across from the JAX
package.

All take plain numpy arrays (``np.asarray`` of the JAX arrays), so this
module needs neither JAX nor ``repro``.  The parity tests run the two
packages on the same converted net or LM this way.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core.conversion import QuantizedNet
from repro_torch.core.encoding import SPECS, EncodingSpec
from repro_torch.lm.config import ArchConfig
from repro_torch.lm.model import check_supported
from repro_torch.lm.radix import torch_dtype

__all__ = ["float_params_from_numpy", "qnet_from_numpy", "qnet_to_numpy",
           "lm_params_from_numpy"]


def float_params_from_numpy(params) -> List[Optional[dict]]:
    """The reference's float ``params`` list (``{"w", "b"}`` or ``None``
    per layer) as float32 CPU tensors."""
    return [None if p is None else
            {k: torch.from_numpy(np.array(p[k], dtype=np.float32))
             for k in ("w", "b")}
            for p in params]


def _tensor(a, dtype):
    return None if a is None else torch.from_numpy(np.array(a, dtype=dtype))


_SPEC_BY_NAME = {cls.name: cls for cls in SPECS}


def _spec(encoding: Union[str, EncodingSpec], num_steps: int,
          fields: dict) -> EncodingSpec:
    """A spec, or a spec name plus its fields (``periods`` for phase,
    ``scale`` for rate) -> the port's spec at ``num_steps``."""
    if isinstance(encoding, str):
        if encoding not in _SPEC_BY_NAME:
            raise ValueError(f"encoding must be a spec or one of "
                             f"{sorted(_SPEC_BY_NAME)}, got {encoding!r}")
        spec = _SPEC_BY_NAME[encoding](num_steps=int(num_steps), **fields)
    else:
        if fields:
            raise ValueError(f"pass fields {sorted(fields)} in the spec, "
                             "not beside it")
        spec = _SPEC_BY_NAME[encoding.name](**_spec_fields(encoding))
    if spec.num_steps != int(num_steps):
        raise ValueError(f"num_steps={num_steps} contradicts "
                         f"{spec}.num_steps={spec.num_steps}")
    return spec


def _spec_fields(spec) -> dict:
    """A spec's dataclass fields (``num_steps`` and any of ``periods``,
    ``scale``) as plain Python values; works on either package's spec."""
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def qnet_from_numpy(static, qlayers, *, num_steps: int, weight_bits: int,
                    input_scale: float, logit_scale,
                    encoding: Union[str, EncodingSpec] = "radix",
                    **fields) -> QuantizedNet:
    """A converted net's fields as numpy (``w_q``, ``b_int``, ``mult`` per
    conv/linear layer, ``None`` for the others) -> the port's
    :class:`QuantizedNet` on the CPU.

    ``encoding`` is a spec (either package's) or a spec name with its
    fields as keywords (``periods=`` for phase, ``scale=`` for rate)."""
    spec = _spec(encoding, num_steps, fields)
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
                        logit_scale=logit_scale, encoding=spec)


def qnet_to_numpy(qnet: QuantizedNet) -> dict:
    """The inverse of :func:`qnet_from_numpy`: keyword fields as numpy,
    the encoding as its name plus its fields beyond ``num_steps``."""
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
        **{k: v for k, v in _spec_fields(qnet.spec).items()
           if k != "num_steps"},
    )


def lm_params_from_numpy(tree, cfg: ArchConfig, *, device=None):
    """The reference's LM ``init_params`` tree (dicts and tuples of numpy
    arrays) -> the port's tree, leaf for leaf and dtype for dtype
    (bfloat16 arrays, which numpy holds as ``ml_dtypes.bfloat16``, become
    ``torch.bfloat16``)."""
    check_supported(cfg)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name in _FLOAT_NAMES:
            t = torch.from_numpy(np.array(a, dtype=np.float32))
            return t.to(device=device, dtype=torch_dtype(a.dtype.name))
        return torch.from_numpy(a.copy()).to(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(walk(v) for v in t)
        return leaf(t)

    return walk(tree)


_FLOAT_NAMES = ("bfloat16", "float16", "float32")
