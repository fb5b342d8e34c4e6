"""Communication chunnels: the int8 block wire format and the fused
compressed wire path (``repro_torch.comm.wire``)."""
