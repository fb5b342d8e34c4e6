"""Communication chunnels: the int8 block wire format, the fused compressed
wire path (``repro_torch.comm.wire``), the gradient collectives on
``torch.distributed`` (``repro_torch.comm.collectives``), and the chunnels
of ``repro_torch.comm.chunnels`` (the gradient transports, the WAN link and
cost calibration), the KV-partition chunnels of decode
(``repro_torch.comm.kvshard``) and the MoE dispatch chunnel
(``repro_torch.comm.moe_dispatch``)."""
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
from repro_torch.comm.kvshard import (
    KVHeadSharded,
    KVSeqSharded,
    flash_decode_local,
    make_head_sharded_decode,
    make_seq_sharded_decode,
    pick_kv_chunnel,
)
from repro_torch.comm.moe_dispatch import MoEDispatch

__all__ = [
    "CostCalibration", "KVHeadSharded", "KVSeqSharded", "MoEDispatch", "REJIT_BLIP_S",
    "UNIT", "WanLinkChunnel", "calibrate_cost_models", "calibrated_objective",
    "cost_calibration", "flash_decode_local", "make_head_sharded_decode",
    "make_seq_sharded_decode", "pick_kv_chunnel", "reset_cost_calibration",
    "wan_region_adaptive_policy",
]
