"""Communication chunnels: the int8 block wire format, the fused compressed
wire path (``repro_torch.comm.wire``), and the host-plane chunnels of
``repro_torch.comm.chunnels`` (the WAN link and cost calibration)."""
from repro_torch.comm.chunnels import (
    REJIT_BLIP_S,
    UNIT,
    CostCalibration,
    WanLinkChunnel,
    calibrate_cost_models,
    calibrated_objective,
    cost_calibration,
    reset_cost_calibration,
    wan_region_adaptive_policy,
)

__all__ = [
    "CostCalibration", "REJIT_BLIP_S", "UNIT", "WanLinkChunnel",
    "calibrate_cost_models", "calibrated_objective", "cost_calibration",
    "reset_cost_calibration", "wan_region_adaptive_policy",
]
