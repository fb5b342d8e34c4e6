"""The port's serving and quickstart examples run on the CPU.

- ``examples/torch_serve_kv.py`` (the counterpart of ``serve_kv.py``, host
  only): the routing switch to the router is committed once and the data
  written before it is read back after it;
- ``examples/torch_quickstart.py`` (the counterpart of ``quickstart.py``):
  negotiation settles on the one pub/sub chunnel both sides speak (SQS),
  the trainer negotiates ``xla`` on one rank and its loss drops over 30
  steps of ``llama3.2-1b``'s smoke config on ``--device cpu``; without
  ``--device`` it asks for the GPU, and raises here.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_kv_switches_routing_and_keeps_the_data():
    out = load("torch_serve_kv").main()
    assert out["switches"] == 1
    assert out["user7"] == {"n": 7}
    assert out["p50_client_s"] > 0 and out["p50_router_s"] > 0


def test_quickstart_negotiates_and_trains():
    # one thread: the 30 steps take about 10 s of one core, where the
    # default pool of every core oversubscribes the workers beside it
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = load("torch_quickstart").main(["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert out["stack"] == "SQS"
    assert out["transport"] == "xla"
    losses = out["losses"]
    assert len(losses) == 30 and losses[-1] < losses[0]


def test_quickstart_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("torch_quickstart").main([])
