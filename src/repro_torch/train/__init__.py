"""The training step and the reconfigurable trainer."""
