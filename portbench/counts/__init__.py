"""Frozen FLOP and byte counts and the chip's peaks, copied from the program's
analysis (``repro_torch.analysis.flops``, ``launch/mesh.py`` ``HW``) and PERF.md's
kernel-bound rule, kept here so that a later change cannot move the yardstick."""
