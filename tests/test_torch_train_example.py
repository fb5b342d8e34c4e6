"""``examples/torch_train_reconfigure.py``, the counterpart of the
reference's ``examples/train_reconfigure.py``, run through its ``main`` on
(pod 2, model 2): four gloo ranks on the CPU (its default is eight)."""
import sys
from pathlib import Path


def test_example_runs_on_pod_and_model_axes(capfd):
    """``examples/torch_train_reconfigure.py`` on (pod 2, model 2), four ranks
    (its default is eight): negotiation, the straggler's 2PC switch, the kill
    and restore, every rank's record alike."""
    # on the path while the ranks start: each imports the example by name
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    try:
        import torch_train_reconfigure as example

        run = example.main(["--device", "cpu", "--threads", "1", "--steps", "20", "--pod", "2",
                            "--model", "2", "--window", "4", "--slow", "1.0"])
    finally:
        sys.path.pop(0)
    assert run["negotiated"] == "psum" and run["transport"] == "compressed_int8"
    assert [(r["to"], r["committed"]) for r in run["reconfig_log"]] == [
        ("compressed_int8", True)]
    assert run["restored_at"] == 10 and len(run["after_restore"]) == 10
    assert "torch_train_reconfigure OK" in capfd.readouterr().out
