"""Three-term roofline of one NVIDIA H100 SXM (the counterpart of the
reference's ``repro/roofline/analysis.py``, whose targets are a TPU v5e).

Terms, as the reference writes them::

    compute    = FLOPs            / (chips × peak_FLOP/s)
    memory     = bytes            / (chips × HBM_bw)
    collective = collective_bytes / (chips × link_bw)

The quantities come from ``roofline.opcount`` (the port's counterpart of
the HLO parser): FLOPs of the products, the bytes each eager op reads and
writes, and the operand bytes of each collective, per device.
:func:`roofline_report` keeps the reference's signature and formulas;
``HW["peak_flops"]`` is the bf16 tensor-core rate.  The card's other
product rates are in :data:`PEAKS` (float32 products run on the CUDA
cores at 1/15 of it): ``roofline.kernels.bound_ms`` and the dry runs'
``compute_s_by_dtype`` price each dtype's FLOPs at its own peak.
"""
from __future__ import annotations

import dataclasses
import math

import torch

#: One H100 SXM (NVIDIA's data sheet, dense rates at the 700 W limit).
HW = {
    "peak_flops": 989e12,     # bf16 tensor-core FLOP/s per card
    "hbm_bw": 3.35e12,        # HBM3 bytes/s per card
    "link_bw": 450e9,         # NVLink 4 bytes/s each way (900 GB/s both)
}

#: Dense product rates by the dtype of the operands (the data sheet's
#: tensor-core rates; float32 is the CUDA cores' FMA rate, which the
#: distance kernels and float32 products without TF32 run at).
PEAKS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
         "float32": 67e12}

#: The reference's collective kinds (XLA's op names).
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"``: the keys of :data:`PEAKS`."""
    return str(dtype).removeprefix("torch.")


def tensor_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype`` (``shape_bytes`` of the
    reference for torch's dtypes; ``()`` is one element)."""
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    return math.prod(int(d) for d in shape) * itemsize


def compute_seconds(flops_by_dtype: dict, hw: dict = HW) -> float:
    """Seconds of the products at each dtype's peak (:data:`PEAKS`; bf16's
    is ``hw``'s ``peak_flops``)."""
    return sum(f / (hw["peak_flops"] if dt == "bfloat16" else PEAKS[dt])
               for dt, f in flops_by_dtype.items())


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D prefill/decode forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    hlo_flops_global: float
    hlo_bytes_global: float
    collective_bytes_global: float
    model_flops: float
    useful_flops_ratio: float    # MODEL_FLOPS / counted FLOPs (global)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_report(*, per_device_flops: float, per_device_bytes: float,
                    per_device_collective_bytes: float, chips: int,
                    n_active_params: int, tokens: int, kind: str,
                    hw: dict = HW) -> RooflineTerms:
    """The reference's arithmetic; the ``hlo_*`` names are kept so that
    its report reads the port's records (here they hold the counted
    quantities, not an HLO module's)."""
    hlo_flops = per_device_flops * chips
    hlo_bytes = per_device_bytes * chips
    coll_bytes = per_device_collective_bytes * chips
    compute_s = hlo_flops / (chips * hw["peak_flops"])
    memory_s = hlo_bytes / (chips * hw["hbm_bw"])
    collective_s = coll_bytes / (chips * hw["link_bw"])
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(n_active_params, tokens, kind)
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck,
        hlo_flops_global=hlo_flops, hlo_bytes_global=hlo_bytes,
        collective_bytes_global=coll_bytes, model_flops=mf,
        useful_flops_ratio=(mf / hlo_flops if hlo_flops else 0.0))


__all__ = ["HW", "PEAKS", "RooflineTerms", "compute_seconds", "dtype_name",
           "model_flops", "roofline_report", "tensor_bytes"]
