"""The sharded trainer's (pod 2, data 2) scenario: ``psum`` with the moments
on their ZeRO-1 blocks over (``data``, ``pod``), on four ranks of its own,
so that ``--dist loadfile`` runs it beside ``test_torch_sharded_train.py``.

The checks are that file's (imported from it, so pytest collects them here
with this file's fixtures): the losses within 2e-2 of the reference trainer
on the same mesh shape, every block its slice of the gathered state,
parameters bit-equal across ``pod`` after every step, the blocks' shapes the
reference's, and the reference's ``test_restore_with_resharding``.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import pytest

from test_torch_sharded_train import (  # noqa: F401 (fixtures and tests collected here)
    four_ranks,
    one_rank,
    ref_params,
    reference,
    shared,
    test_blocks_equal_slices_of_gathered_state,
    test_blocks_have_reference_shard_shapes,
    test_losses_match_one_rank_run,
    test_losses_match_reference_trainer,
    test_params_bit_equal_across_pod,
    test_restore_with_resharding,
)

NAMES = ("pod2_data2_psum",)


@pytest.fixture(scope="module")
def names():
    return NAMES


@pytest.fixture(params=NAMES)
def scenario(request):
    return request.param
