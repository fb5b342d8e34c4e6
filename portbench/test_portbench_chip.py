"""The run's contract at its ends: without a card it exits with an error and
prints no result; on a card (``-m cuda``) a short traced run of each cell
prints one correct JSON line last, its compared numbers last of all."""
import json

import pytest

from portbench import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_without_a_card_the_run_refuses(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", CELLS[0], "--seed", "2147483648", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_traced_run_on_the_card(workload, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert run.main(["--workload", workload, "--seed", "4294967311", "--seconds", "4",
                     "--trace", "1"]) == 0
    out = capsys.readouterr()
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "check"
    assert result["device"]["busy_s"] > 0 and result["metrics"]
    assert out.err.strip().splitlines()[-1].startswith("check ")
