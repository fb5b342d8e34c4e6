"""Comm-layer chunnels: the gradient transports, the WAN link, cost calibration.

Step chunnels (the reference's ``StepChunnel`` and its seven ``Grad*``
transports) are Bertha chunnels whose datapath is the training step: every
rank applies the negotiated stack to its gradient tree between backward and
the optimizer. Every collective chunnel is multilateral: ranks must run the
identical sequence of collectives or the job deadlocks at the first
mismatch — exactly the incompatibility Bertha's negotiation exists to
prevent. The exact-match capability labels below are what the host agents
negotiate. The gradient-transport Select:

    Select(GradXla(), GradHierarchical(), GradRing(), GradCompressed())

GradXla leaves the sync to the step, which averages the gradients over every
batch axis with one framework all-reduce (the reference leaves it to XLA's
partitioner); the others take control of their axes (``manual_axes``) and
place the collectives of ``repro_torch.comm.collectives`` themselves. The
int8 transports take ``device=`` as every entry point of the port does: on
the GPU their wire runs the Hopper kernels ``quantize_pack`` and
``unpack_dequant_sum``, on the CPU their plain versions. On a mesh that
splits the gradient the step hands a transport the rank's blocks and
``ctx["shards"]`` (``train.gradshard.GradShards``): the float32 ones reduce
the blocks as they are, the int8 ones by their plan for their ``frame``,
which gathers only the leaves whose blocks are not whole blocks of the
wire.

``WanLinkChunnel`` is the "compressed + reliable" option a region's Select
moves to when its link turns lossy: float batches ride the int8 block wire
(``repro_torch.comm.wire``: one launch of the Hopper kernel ``quantize_pack``
per contiguous run of tensors on send, one ``unpack_dequant`` per blob on
receive), chunked to the MTU and carried by go-back-N windows with
keepalives. The peer is ``repro_torch.serving.gateway.WanGateway``.

The cost calibration derives the transport cost models' terms from the live
mesh width and a measured link bandwidth, and installs trace-measured
per-chunnel costs into the core scorer (``repro_torch.obs.calibrate``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.backend import resolve_device
from repro_torch.comm import collectives
from repro_torch.comm.compress import int8_wire_ratio, quantize_error
from repro_torch.comm.wire import Reassembler, chunk_payload, decode_blob, encode_batch
from repro_torch.core.capability import CapabilitySet
from repro_torch.core.chunnel import Chunnel, Datapath, WireType
from repro_torch.core.controller import (
    PolicyContext,
    Rule,
    above,
    all_of,
    below,
    register_policy,
)
from repro_torch.core.cost import CostModel, install_measured_costs, reset_measured_costs
from repro_torch.core.fabric import ReliableChannel
from repro_torch.obs.trace import NOOP_SPAN, TRACER

GRADS_F32 = WireType.of("grads", dtype="f32")
UNIT = WireType.of("unit")


#: every step-transport switch rebuilds the step function — that blip
#: dominates the mechanism cost and is identical across transports, so the
#: scorer's switch-aversion for this plane is uniform (see
#: repro_torch.core.cost)
REJIT_BLIP_S = 2.0


# ---------------------------------------------------------------------------
# Mesh-aware cost calibration (ROADMAP "Mesh-aware cost models")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CostCalibration:
    """Live overrides for the static transport cost annotations.

    n_fast            the LIVE fast-axis width — hierarchy credit in
                      ``dcn_bytes_factor`` divides by this instead of the
                      static ``StepChunnel.NOMINAL_FAST`` guess
    dcn_bytes_per_s   measured slow-tier link bandwidth (e.g. from
                      ``repro_torch.fleet.signals.LinkBandwidthSignal``) — feeds
                      ``calibrated_objective``'s byte→seconds normalizer
    """

    n_fast: Optional[int] = None
    dcn_bytes_per_s: Optional[float] = None


_CALIBRATION = CostCalibration()


def calibrate_cost_models(*, mesh=None, fast_axis: str = "data",
                          link_bytes_per_s: Optional[float] = None,
                          signal=None, measured=None) -> CostCalibration:
    """Derive the transport cost models' terms from the live mesh shape and a
    measured link bandwidth, instead of the static ``NOMINAL_FAST``
    annotation. Process-wide (the mesh is process-wide too): the trainer
    calls this at construction; ``reset_cost_calibration`` restores the
    static annotations (tests). ``signal`` is anything whose ``read()``
    yields ``ext.link_bytes_per_s`` (``LinkBandwidthSignal``); an explicit
    ``link_bytes_per_s`` wins over it. Fields not derivable from THIS call's
    arguments keep their current calibration (so the trainer installing its
    mesh width does not wipe a previously measured bandwidth).

    ``measured`` installs trace-derived per-chunnel cost overrides — either
    a ``repro_torch.obs.calibrate.TraceCalibration`` or a plain
    ``{chunnel_name: {cost field: value}}`` dict — into the core scorer's
    measured tables (``repro_torch.core.cost.install_measured_costs``); the full
    loop is ``calibrate_from_traces(records)``, which calls this.
    """
    global _CALIBRATION
    n_fast = _CALIBRATION.n_fast
    if mesh is not None and fast_axis in getattr(mesh, "axis_names", ()):
        n_fast = int(mesh.shape[fast_axis])
    bw = link_bytes_per_s
    if bw is None and signal is not None:
        bw = (signal.read() or {}).get("ext.link_bytes_per_s")
    if bw is None:
        bw = _CALIBRATION.dcn_bytes_per_s
    if measured is not None:
        chunnels = getattr(measured, "chunnels", measured)
        blips = getattr(measured, "stack_blips", None) or {}
        install_measured_costs(chunnels=chunnels, stack_blips=blips)
    _CALIBRATION = CostCalibration(n_fast=n_fast, dcn_bytes_per_s=bw)
    return _CALIBRATION


def cost_calibration() -> CostCalibration:
    return _CALIBRATION


def reset_cost_calibration() -> None:
    """Restore static annotations: the mesh/bandwidth calibration AND any
    trace-derived measured cost overrides."""
    global _CALIBRATION
    _CALIBRATION = CostCalibration()
    reset_measured_costs()


def calibrated_objective(base):
    """``base`` (a ``repro_torch.core.cost.Objective``) with its byte→seconds
    normalizer derived from the measured link bandwidth, when one has been
    calibrated — so byte-weighted scoring reflects the link the fleet
    actually runs on, not the nominal 1 GB/s default."""
    bw = _CALIBRATION.dcn_bytes_per_s
    if not bw:
        return base
    return dataclasses.replace(base, dcn_s_per_byte=1.0 / bw,
                               name=f"{base.name}@measured")


class StepChunnel(Chunnel):
    """A chunnel applied to gradient trees inside the training step.

    ``apply(tree, state, ctx)`` runs on every rank between backward and the
    optimizer; ``ctx["mesh"]`` is the rank's mesh.
    """

    multilateral = True  # SPMD: all hosts must agree
    upper_type = GRADS_F32
    lower_type = UNIT

    #: mesh axes this chunnel takes control of
    manual_axes: tuple = ()

    #: nominal fast-axis width assumed by cost models that divide DCN bytes by
    #: |fast| when NO live calibration is installed — the fallback for code
    #: that scores transports without a mesh in hand (coarse on purpose; the
    #: scorer only needs ordering). ``calibrate_cost_models(mesh=...)``
    #: replaces it with the live axis width.
    NOMINAL_FAST = 4

    def fast_width(self) -> int:
        """Fast-axis width the cost model divides DCN bytes by: the LIVE
        calibrated width when ``calibrate_cost_models`` has seen a mesh,
        else the static ``NOMINAL_FAST`` annotation."""
        cal = cost_calibration()
        return cal.n_fast if cal.n_fast else self.NOMINAL_FAST

    #: False for transports that trade gradient freshness for communication
    #: (localsgd-style): their cost models honestly win the comm-cost contest,
    #: so scoring policies must not treat them as steady-state candidates —
    #: only an explicit mitigation rule may select them
    exact_sync = True

    def init_state(self, grads_shape):
        return ()

    def frame(self, mesh) -> tuple:
        """(block, chunks) of the wire's frame on ``mesh``: the blocks its
        values are quantized in, over how many chunks of the flat vector.
        The float32 transports are elementwise: (1, 1)."""
        return (1, 1)

    def apply(self, tree, state, ctx: dict):
        raise NotImplementedError

    def connect_wrap(self, inner: Optional[Datapath]) -> Datapath:
        return _StepDatapath(self, inner)


class _StepDatapath(Datapath):
    def __init__(self, ch: StepChunnel, inner: Optional[Datapath]):
        self.ch = ch
        self.inner = inner

    def send(self, msgs):
        raise RuntimeError("step chunnels run inside the step via apply(), not send()")

    recv = send


def apply_grad_stack(chunnels, tree, states, ctx):
    """Fold grads through the stack top-down; returns (tree, new_states)."""
    new_states = []
    for ch, st in zip(chunnels, states):
        tree, st = ch.apply(tree, st, ctx)
        new_states.append(st)
    return tree, tuple(new_states)


def stack_manual_axes(chunnels) -> set:
    out = set()
    for ch in chunnels:
        out |= set(getattr(ch, "manual_axes", ()))
    return out


def init_grad_states(chunnels, grads_shape):
    """Each chunnel's initial state for gradients shaped like
    ``grads_shape`` (a tree of tensors; only shapes and devices are read)."""
    return tuple(ch.init_state(grads_shape) for ch in chunnels)


def _div(tree, n):
    return T.map(lambda g: g / n, tree)


def _plan(ch: StepChunnel, ctx: dict):
    """``ch``'s plan of the rank's own shard of the gradient
    (``train.gradshard``), or None where the step hands it whole leaves."""
    shards = ctx.get("shards")
    return None if shards is None else shards.plan(*ch.frame(ctx["mesh"]))


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


@dataclass
class GradXla(StepChunnel):
    """Leave gradient sync to the step's one all-reduce (the 'kernel stack')."""

    axis: str = "pod"
    manual_axes = ()

    @property
    def name(self):
        return "GradXla"

    def capabilities(self):
        return CapabilitySet.exact("wire:f32").union_(
            CapabilitySet.compose("transport:xla"))

    def cost_model(self):
        # baseline: one fused f32 AR per step
        return CostModel(op_latency_s=3e-3,
                         dcn_bytes_per_byte=collectives.dcn_bytes_factor("xla"),
                         switch_blip_s=REJIT_BLIP_S)

    def apply(self, tree, state, ctx):
        return tree, state  # the step's all-reduce syncs the gradients


@dataclass
class GradPsum(StepChunnel):
    """Explicit all-reduce mean over the slow axis."""

    axis: str = "pod"

    def __post_init__(self):
        self.manual_axes = (self.axis,)

    @property
    def name(self):
        return "GradPsum"

    def capabilities(self):
        return CapabilitySet.exact("wire:f32", f"transport:psum@{self.axis}")

    def cost_model(self):
        return CostModel(op_latency_s=3e-3,
                         dcn_bytes_per_byte=collectives.dcn_bytes_factor("psum"),
                         switch_blip_s=REJIT_BLIP_S)

    def apply(self, tree, state, ctx):
        return collectives.pmean_tree(tree, ctx["mesh"], self.axis), state


@dataclass
class GradRing(StepChunnel):
    """Ring reduce-scatter + all-gather by point-to-point sends (explicit
    schedule)."""

    axis: str = "pod"

    def __post_init__(self):
        self.manual_axes = (self.axis,)

    @property
    def name(self):
        return "GradRing"

    def capabilities(self):
        return CapabilitySet.exact("wire:f32", f"transport:ring@{self.axis}")

    def cost_model(self):
        # same DCN bytes as psum, but 2(n-1) dependent steps instead of one
        # fused AR: higher per-step latency on real links
        return CostModel(op_latency_s=4e-3,
                         dcn_bytes_per_byte=collectives.dcn_bytes_factor("ring"),
                         switch_blip_s=REJIT_BLIP_S)

    def apply(self, tree, state, ctx):
        mesh = ctx["mesh"]
        return _div(collectives.ring_tree(tree, mesh, self.axis), mesh.shape[self.axis]), state


@dataclass
class GradHierarchical(StepChunnel):
    """RS(fast) -> AR(slow) -> AG(fast): per-rank slow-tier bytes / |fast|.

    INCOMPATIBLE with FSDP over the fast axis (the reference's finding: taking
    'data' manual replicates FSDP-sharded params); negotiation enforces this
    through the layout:noshard exact capability below.
    """

    fast_axis: str = "data"
    slow_axis: str = "pod"

    def __post_init__(self):
        self.manual_axes = (self.fast_axis, self.slow_axis)

    @property
    def name(self):
        return "GradHierarchical"

    def capabilities(self):
        # exact 'layout:noshard@fast' conflicts with FSDP stacks (which carry
        # 'layout:fsdp@data'): Bertha's negotiation rejects the combination.
        return CapabilitySet.exact(
            "wire:f32", f"transport:hier@{self.fast_axis}+{self.slow_axis}",
            f"layout:noshard@{self.fast_axis}")

    def cost_model(self):
        return CostModel(
            op_latency_s=2e-3,
            dcn_bytes_per_byte=collectives.dcn_bytes_factor(
                "hierarchical", n_fast=self.fast_width()),
            switch_blip_s=REJIT_BLIP_S)

    def apply(self, tree, state, ctx):
        mesh = ctx["mesh"]
        n = mesh.shape[self.slow_axis] * mesh.shape[self.fast_axis]
        out = collectives.hierarchical_tree(tree, mesh, self.fast_axis, self.slow_axis)
        return _div(out, n), state


@dataclass
class GradCompressed(StepChunnel):
    """int8 block-quantized DCN wire format + error feedback (multilateral:
    both ends must speak wire:int8-blockq — the serialization-chunnel analogue).

    ``device`` is where the wire's kernels run: ``"cuda"`` (the default)
    raises at construction without a GPU; ``"cpu"`` runs their plain
    versions."""

    axis: str = "pod"
    block: int = 256
    error_feedback: bool = True
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.manual_axes = (self.axis,)
        self.device = resolve_device(self.device)

    @property
    def name(self):
        return "GradCompressed"

    def capabilities(self):
        return CapabilitySet.exact(f"wire:int8-blockq{self.block}",
                                   f"transport:cag@{self.axis}")

    def cost_model(self):
        # 4x fewer DCN bytes, but quantize/dequantize compute on the fast path
        return CostModel(
            op_latency_s=2.5e-3,
            dcn_bytes_per_byte=collectives.dcn_bytes_factor(
                "compressed", wire_ratio=int8_wire_ratio(self.block)),
            switch_blip_s=REJIT_BLIP_S)

    def init_state(self, grads_shape):
        if not self.error_feedback:
            return ()
        return T.map(lambda s: torch.zeros(s.shape, dtype=torch.float32, device=self.device),
                     grads_shape)

    def frame(self, mesh) -> tuple:
        return (self.block, 1)

    def apply(self, tree, state, ctx):
        mesh = ctx["mesh"]
        n = mesh.shape[self.axis]
        ef = self.error_feedback and state != ()
        if ef:  # elementwise: on the rank's blocks, before any gather
            tree = T.map(lambda g, r: g.to(torch.float32) + r, tree, state)
        plan = _plan(self, ctx)
        view = plan.gather(tree) if plan is not None else tree
        out = collectives.compressed_tree(view, mesh, self.axis, block=self.block)
        new_state = state
        if ef:
            # residual of OUR contribution (what we failed to transmit), one
            # quantize and one dequantize per leaf (an own leaf's block is
            # whole blocks of the leaf)
            new_state = T.map(lambda g: quantize_error(g, block=self.block), view)
        if plan is not None:
            out = plan.cut(out)
            new_state = plan.cut(new_state) if ef else new_state
        return _div(out, n), new_state


@dataclass
class GradHierCompressed(StepChunnel):
    """Beyond-paper: hierarchical + compressed DCN tier combined."""

    fast_axis: str = "data"
    slow_axis: str = "pod"
    block: int = 256
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.manual_axes = (self.fast_axis, self.slow_axis)
        self.device = resolve_device(self.device)

    @property
    def name(self):
        return "GradHierCompressed"

    def capabilities(self):
        return CapabilitySet.exact(
            f"wire:int8-blockq{self.block}",
            f"transport:hiercag@{self.fast_axis}+{self.slow_axis}",
            f"layout:noshard@{self.fast_axis}",
        )

    def cost_model(self):
        return CostModel(
            op_latency_s=2.2e-3,
            dcn_bytes_per_byte=collectives.dcn_bytes_factor(
                "hier_compressed", n_fast=self.fast_width(),
                wire_ratio=int8_wire_ratio(self.block)),
            switch_blip_s=REJIT_BLIP_S)

    def frame(self, mesh) -> tuple:
        return (self.block, mesh.shape[self.fast_axis])

    def apply(self, tree, state, ctx):
        mesh = ctx["mesh"]
        n = mesh.shape[self.slow_axis] * mesh.shape[self.fast_axis]
        plan = _plan(self, ctx)
        view = plan.gather(tree) if plan is not None else tree
        # a view is reduce-scattered by the reference's chunks of the flat vector
        out = collectives.hierarchical_compressed_tree(
            view, mesh, self.fast_axis, self.slow_axis, block=self.block,
            lengths=plan.chunk_lengths() if plan is not None else None)
        return _div(plan.cut(out) if plan is not None else out, n), state


@dataclass
class GradLocalSGD(StepChunnel):
    """Straggler/elasticity mitigation: sync every H steps, accumulate locally
    otherwise (async-ish DCN relief; a reconfiguration target when the runtime
    detects slow pods).

    The step counter is a Python int in the state, the same on every rank
    (every rank applies the stack once per step), so every rank decides to
    sync at the same step."""

    axis: str = "pod"
    sync_every: int = 4
    exact_sync = False  # H-1 of H steps run on stale pod-local gradients

    def __post_init__(self):
        self.manual_axes = (self.axis,)

    @property
    def name(self):
        return "GradLocalSGD"

    def capabilities(self):
        return CapabilitySet.exact("wire:f32", f"transport:localsgd{self.sync_every}@{self.axis}")

    def cost_model(self):
        # Honest about COMMUNICATION cost only: skipping the AR on H-1 of H
        # steps genuinely is the cheapest transport on both scored dimensions.
        # The price — gradient staleness / statistical efficiency — is outside
        # the model, so scoring policies must treat localsgd as a straggler
        # MITIGATION, not a steady-state candidate (trainer_default excludes
        # the mitigation target from its scored byte-budget argmax).
        return CostModel(
            op_latency_s=1e-3,
            dcn_bytes_per_byte=collectives.dcn_bytes_factor(
                "localsgd", sync_every=self.sync_every),
            switch_blip_s=REJIT_BLIP_S)

    def init_state(self, grads_shape):
        return {"step": 0}

    def apply(self, tree, state, ctx):
        step = int(state["step"])
        if step % self.sync_every == self.sync_every - 1:
            tree = collectives.pmean_tree(tree, ctx["mesh"], self.axis)
        return tree, {"step": step + 1}


TRANSPORTS = {
    "xla": GradXla,
    "psum": GradPsum,
    "ring": GradRing,
    "hierarchical": GradHierarchical,
    "compressed_int8": GradCompressed,
    "hier_compressed": GradHierCompressed,
    "localsgd": GradLocalSGD,
}

#: the transports whose wire runs kernels, and so take ``device=``
DEVICE_TRANSPORTS = ("compressed_int8", "hier_compressed")


def make_transport(name: str, **kw) -> StepChunnel:
    return TRANSPORTS[name](**kw)


def transport_chunnels(name: str, mesh, device) -> tuple:
    """The trainer's gradient stack for transport ``name`` on ``mesh``: none
    for ``xla`` or on a mesh without a ``pod`` axis; the hierarchical ones
    over (``data``, ``pod``), the others over ``pod``; a kernel-running
    wire's on ``device``."""
    if name == "xla" or "pod" not in mesh.axis_names:
        return ()
    kw = ({"fast_axis": "data", "slow_axis": "pod"}
          if name in ("hierarchical", "hier_compressed") else {"axis": "pod"})
    if name in DEVICE_TRANSPORTS:
        kw["device"] = device
    return (make_transport(name, **kw),)


# ---------------------------------------------------------------------------
# WAN link layer (host plane, ROADMAP direction 5)
# ---------------------------------------------------------------------------


class WanLinkChunnel(Chunnel):
    """WAN-grade link transport: the "compressed + reliable" stack option a
    region adopts when its links turn hostile (docs/architecture.md §9).

    Layers, top down:
      * MTU-aware chunking/reassembly of large tensors through the
        ``comm/wire.py`` frame format — float batches ride the fused int8
        block-quantized encode (the compressed wire), opaque byte payloads
        are chunked raw, small control messages pass through whole;
      * go-back-N retransmission: every frame batch goes through one
        ``ReliableChannel.request_window`` call, so delivery is confirmed
        (``send`` returns only once the peer acked the window) and loss is
        repaired by retransmit instead of surfacing to the application;
      * keepalives: ``ping()`` probes the peer fail-fast, ``alive()`` tracks
        last-heard age, so a region notices a partition without waiting for
        a full send to stall out.

    Unilateral by design: the peer is a dedicated WAN gateway endpoint
    (``repro_torch.serving.gateway.WanGateway``) that always speaks this frame
    format, so a region can adopt or drop the WAN stack without negotiating
    with anyone — the same shape as the serving plane's ClientShard option.

    Float tensors encode and decode on ``device``: on ``"cuda"`` through the
    Hopper kernels, on ``"cpu"`` through their plain PyTorch versions, the
    same bytes either way. ``"cuda"`` is the default and raises at
    construction without a GPU.
    """

    upper_type = WireType.of("bytes")
    lower_type = UNIT
    multilateral = False

    def __init__(self, ep, peer: str, *, mtu_bytes: int = 4096,
                 window: int = 8, timeout_s: float = 0.03, retries: int = 8,
                 keepalive_s: float = 0.25, block: int = 256,
                 device: str | torch.device = "cuda", max_partial: int = 64,
                 label: str = "WanLink"):
        self.ep = ep
        self.peer = peer
        self.mtu_bytes = mtu_bytes
        self.window = window
        self.timeout_s = timeout_s
        self.retries = retries
        self.keepalive_s = keepalive_s
        self.block = block
        self.device = resolve_device(device)  # "cuda" without a GPU raises here
        self.max_partial = max_partial
        self._label = label

    @property
    def name(self) -> str:
        return self._label

    def capabilities(self) -> CapabilitySet:
        # compose, not exact: the gateway side always speaks the WAN frame
        # format, so adopting it is a one-sided decision per region
        return CapabilitySet.compose("link:wan-gbn", f"link:q8b{self.block}")

    def cost_model(self) -> CostModel:
        return CostModel(op_latency_s=2e-3,
                         dcn_bytes_per_byte=int8_wire_ratio(self.block),
                         switch_blip_s=2e-3)

    def connect_wrap(self, inner: Optional[Datapath]) -> Datapath:
        assert inner is None, "transport chunnels bootstrap from the unit type"
        return _WanLinkDP(self)


def _is_float_tensor(m) -> bool:
    """A float tensor or array, which rides the int8 wire. ``np.dtype``
    rejects a torch dtype, so a torch tensor is asked directly: a float
    tensor taken for an opaque object would ride the fabric whole and skip
    the wire."""
    if isinstance(m, torch.Tensor):
        return torch.is_floating_point(m)
    dt = getattr(m, "dtype", None)
    if dt is None:
        return False
    try:
        return np.issubdtype(np.dtype(dt), np.floating)
    except TypeError:
        return False


class _WanLinkDP(Datapath):
    """Live WAN link: one ``request_window`` per batch on the send side, a
    ``serve_one`` pump + bounded ``Reassembler`` on the receive side."""

    def __init__(self, ch: WanLinkChunnel):
        self.ch = ch
        self._chan = ReliableChannel(ch.ep, ch.peer, timeout=ch.timeout_s,
                                     retries=ch.retries, window=ch.window)
        self._reasm = Reassembler(max_partial=ch.max_partial)
        self._ready: deque = deque()
        self._last_heard = time.monotonic()
        self.msgs_sent = 0
        self.frames_sent = 0
        self.failed_sends = 0
        self.pings_ok = 0
        self.keepalive_failures = 0

    # -- send: classify, encode, one reliable window per batch ----------------
    def send(self, msgs):
        msgs = list(msgs)
        if not msgs:
            return
        # ONE batch-level span (the span-in-hot-loop rule forbids per-frame
        # spans here); chunk headers inherit its ctx inside chunk_payload,
        # and the rc.window span underneath tags each retransmit retry=n.
        sp = (TRACER.span("wan.send", attrs={"peer": self.ch.peer,
                                             "n": len(msgs),
                                             "chunnel": self.ch.name})
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            frames: list = []
            tensors: list = []

            def flush_tensors():
                if tensors:
                    frames.extend(encode_batch(
                        tensors, block=self.ch.block,
                        device=self.ch.device,
                        chunk_bytes=self.ch.mtu_bytes))
                    tensors.clear()

            for m in msgs:
                if _is_float_tensor(m):
                    tensors.append(m)  # contiguous runs share one device call
                elif isinstance(m, (bytes, bytearray)):
                    flush_tensors()
                    frames.extend(chunk_payload(bytes(m), {"kind": "raw"},
                                                chunk_bytes=self.ch.mtu_bytes))
                else:
                    flush_tensors()
                    frames.append({"_obj": m})
            flush_tensors()
            self.msgs_sent += len(msgs)
            self.frames_sent += len(frames)
            sp.set(frames=len(frames))
            try:
                self._chan.request_window(frames)
            except TimeoutError:
                self.failed_sends += 1
                # the batch is NOT delivered: close the span as a drop
                sp.set(status="dropped", drop_reason="window_stalled")
                raise
            self._last_heard = time.monotonic()

    # -- receive: pump the reliable server side into the ready queue ----------
    def recv(self, buf, timeout=None):
        n_out = self._drain(buf, 0)
        deadline = None if timeout is None else time.monotonic() + timeout
        while n_out < len(buf):
            if n_out:
                t: Optional[float] = 0.0  # drain-only once delivering
            elif deadline is None:
                t = None
            else:
                t = deadline - time.monotonic()
                if t <= 0:
                    break
            if not self._chan.serve_one(self._ingest_frame, timeout=t):
                if n_out or t == 0.0:
                    break
                continue  # spurious wakeup (stray frame): keep waiting
            n_out = self._drain(buf, n_out)
        return n_out

    def _ingest_frame(self, src, body):
        self._last_heard = time.monotonic()
        if isinstance(body, dict):
            if "_wire" in body:
                done = self._reasm.ingest(body)
                if done is not None:
                    payload, hdr = done
                    if TRACER.enabled:
                        TRACER.event("wire.reassembled",
                                     attrs={"bytes": len(payload),
                                            "kind": hdr.get("kind", "tensor")},
                                     ctx=hdr.get("tc"))
                    if hdr.get("kind") == "raw":
                        self._ready.append(payload)
                    else:
                        self._ready.extend(decode_blob(
                            payload, hdr, device=self.ch.device))
                return {"ok": True}
            if "_ka" in body:
                return {"pong": True}
            if "_obj" in body:
                self._ready.append(body["_obj"])
                return {"ok": True}
        self._ready.append(body)
        return {"ok": True}

    def _drain(self, buf, n_out: int) -> int:
        while n_out < len(buf) and self._ready:
            buf[n_out] = self._ready.popleft()
            n_out += 1
        return n_out

    # -- keepalives ------------------------------------------------------------
    def ping(self, retries: int = 3) -> bool:
        """Fail-fast liveness probe; updates last-heard on success."""
        try:
            self._chan.request({"_ka": True}, retries=retries)
        except TimeoutError:
            self.keepalive_failures += 1
            return False
        self.pings_ok += 1
        self._last_heard = time.monotonic()
        return True

    def alive(self, now: Optional[float] = None, grace: float = 3.0) -> bool:
        """Heard from the peer within ``grace`` keepalive periods?"""
        now = time.monotonic() if now is None else now
        return (now - self._last_heard) <= grace * self.ch.keepalive_s

    def keepalive_due(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return (now - self._last_heard) >= self.ch.keepalive_s

    # -- observability ----------------------------------------------------------
    @property
    def retransmits(self) -> int:
        return self._chan.retransmits

    def stats(self) -> dict:
        """Link-health counters a region controller can fold into its
        telemetry snapshot (``link.*`` keys in ``wan_region_adaptive``)."""
        return {
            "msgs_sent": self.msgs_sent,
            "frames_sent": self.frames_sent,
            "failed_sends": self.failed_sends,
            "retransmits": self._chan.retransmits,
            "retransmit_ratio":
                self._chan.retransmits / max(1, self.frames_sent),
            "keepalive_failures": self.keepalive_failures,
            "partial_blobs": self._reasm.partial_count(),
            "evicted_partials": self._reasm.evicted,
        }


@register_policy("wan_region_adaptive")
def wan_region_adaptive_policy(ctx: PolicyContext) -> List[Rule]:
    """Per-region link-health policy (ROADMAP direction 5): a lossy region
    moves its Select to the WAN compressed+reliable option; a region whose
    link is clean (and whose WAN datapath isn't retransmitting) recovers to
    the fast path. Reads two scenario-fed snapshot keys:

      link.timeout_ratio     fraction of recent probes that timed out
                             (1.0 during a hard partition)
      link.retransmit_ratio  WAN-link retransmits per frame sent — nonzero
                             while the link still drops frames, so recovery
                             only arms on genuinely clean links
    """
    p = ctx.params
    breach = p.get("breach_timeout_ratio", 0.05)
    recover = p.get("recover_timeout_ratio", 0.01)
    rtx_ok = p.get("recover_retransmit_ratio", 0.02)
    hold = p.get("hold", 2)
    wan = ctx.candidate_named(*p.get("wan_names", ("WanLink",))).target
    fast = ctx.candidate_named(
        *p.get("fast_names", ("FastWire", "FabricTransport"))).target
    return [
        Rule("lossy-wan->compressed-reliable",
             above("link.timeout_ratio", breach), wan,
             hold=hold, priority=1),
        Rule("clean-link->fast-path",
             all_of(below("link.timeout_ratio", recover),
                    below("link.retransmit_ratio", rtx_ok)),
             fast, hold=hold, priority=0),
    ]
