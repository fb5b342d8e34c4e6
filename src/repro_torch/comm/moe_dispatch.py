"""MoE dispatch chunnels: the negotiation-facing side of the expert-dispatch
Select in ``repro_torch/models/moe.py``.

The counterpart of ``src/repro/comm/moe_dispatch.py``:

  grouped    capacity gather/scatter on one device
  alltoall   expert-parallel all-to-all over ``model``
  allgather  local experts for all tokens, summed over ``model``

All are multilateral (SPMD) with exact capability labels
(``moe:<impl>@<axis>``), so negotiation picks an impl both sides name
exactly; ``dense`` is the oracle. The chunnel moves no gradient: the model
reads the negotiated impl from its config (:func:`configure`). Without a
mesh that has a ``model`` axis, ``moe_ffn`` runs ``alltoall`` and
``allgather`` as ``grouped``, as the reference does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.comm.chunnels import StepChunnel
from repro_torch.core.capability import CapabilitySet


@dataclass
class MoEDispatch(StepChunnel):
    impl: str = "grouped"  # dense | grouped | alltoall | allgather
    axis: str = "model"

    def __post_init__(self):
        self.manual_axes = (self.axis,) if self.impl in ("alltoall", "allgather") else ()

    @property
    def name(self):
        return f"MoEDispatch[{self.impl}]"

    def capabilities(self):
        return CapabilitySet.exact(f"moe:{self.impl}@{self.axis}")

    def apply(self, tree, state, ctx):
        return tree, state  # resolved through ModelConfig.moe.dispatch


def configure(cfg, impl: str):
    """``cfg`` with the negotiated dispatch impl."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=impl))
