"""Quickstart on the PyTorch port: build a chunnel stack, negotiate, train a
small LM, watch its loss drop.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py``, on ``repro_torch``:

  1. the paper's abstractions — a server offers a Select of two pub/sub
     chunnels (Kafka preferred, SQS), a client speaks only SQS, and
     negotiation settles on SQS;
  2. the same machinery driving a training job — the port's
     ``ReconfigurableTrainer`` on ``llama3.2-1b``'s smoke config negotiates
     its gradient transport and takes 30 steps on one rank; the loss must
     drop.

It runs on ``--device`` (``cuda`` by default, which raises without a GPU).
``main(argv)`` returns the negotiated stack's name, the transport and the
losses.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.backend import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import Fabric, FnChunnel, HostAgent, Select, make_stack
from repro_torch.core.capability import CapabilitySet
from repro_torch.data.synthetic import batches_for
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

STEPS = 30


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # no GPU: raise before anything starts

    # -----------------------------------------------------------------------
    # 1. The paper's abstractions: stacks, selects, negotiation
    # -----------------------------------------------------------------------
    fabric = Fabric()
    server, client = HostAgent(fabric, "srv"), HostAgent(fabric, "cli")
    try:
        kafka = FnChunnel(fn_name="Kafka", caps=CapabilitySet.exact("pubsub:kafka"))
        sqs = FnChunnel(fn_name="SQS", caps=CapabilitySet.exact("pubsub:sqs"))
        server.listen(make_stack(Select(kafka, sqs)))  # server prefers kafka
        conn = client.connect("srv", make_stack(sqs))  # client only speaks sqs
        print(f"negotiated stack: {conn.stack} (nonce={conn.nonce})")
        negotiated = str(conn.stack)
    finally:
        server.close()
        client.close()

    # -----------------------------------------------------------------------
    # 2. The same machinery driving a training job
    # -----------------------------------------------------------------------
    cfg = get_smoke_config("llama3.2-1b")
    shape = ShapeConfig("quickstart", 128, 8, "train")
    mesh = make_mesh((1,), ("data",), device=dev)
    trainer = ReconfigurableTrainer(
        cfg, shape, mesh,
        tcfg=TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=STEPS),
        hosts=[HostSpec(0, ["xla"])],
    )
    print(f"negotiated transport: {trainer.transport_name}")
    state = trainer.init_state(0)
    state, hist = trainer.run(state, batches_for(cfg, shape), STEPS)
    losses = [h["loss"] for h in hist]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(hist)} steps")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the synthetic LM's loss did not drop: {losses}")
    print("quickstart OK")
    return {"stack": negotiated, "transport": trainer.transport_name, "losses": losses}


if __name__ == "__main__":
    main()
