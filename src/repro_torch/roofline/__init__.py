"""Roofline of the port on one H100: the card's peaks and the three-term
arithmetic (``analysis``), the costs of the ops a step runs
(``opcount``), the hand-written kernels' declared costs (``kernels``)
and dry runs of the LLM paths on the ``meta`` device (``dryrun``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HW, PEAKS, model_flops, roofline_report)
from repro_torch.roofline.dryrun import dry_run  # noqa: F401
from repro_torch.roofline.opcount import Costs, count  # noqa: F401
