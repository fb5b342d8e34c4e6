"""Reconfigurable trainer: the Bertha runtime driving the training step.

The counterpart of ``src/repro/train/trainer.py``. Host agents negotiate the
gradient transport through the rendezvous store before the first step,
guaranteeing that every rank runs the identical sequence of collectives. The
trainer then runs the step, and can RECONFIGURE between steps without
losing state:

  * params/optimizer state carry over (they live outside the chunnels),
  * chunnel state is migrated (error-feedback residuals are re-zeroed when
    the wire format changes — the paper's state-translation step),
  * the switch point is the step boundary.

Layout: the state lies on the mesh by ``step.shardings_for`` (FSDP over
``data``, tensor parallelism over ``model``, ZeRO-1 moments over ``pod``;
``sharding=``). Each rank holds its block of every parameter, moment and
error-feedback residual; a transport switch derives the shardings again and
lays the state out anew where they changed.

Fault tolerance:
  * periodic + async checkpoints (atomic; every rank gathers the state's
    full leaves, rank 0 writes them, and the others wait for it at a barrier
    before reading; a restore keeps each rank's block, on any mesh),
  * heartbeat monitor: hosts report step times; persistent stragglers trigger
    a negotiated transition to a DCN-lighter transport (compressed / localsgd)
    — reconfiguration as *mitigation*, the paper's core pitch.

Closed loop: the trainer feeds a ConnTelemetry (per-pod step times from the
heartbeat plane, estimated DCN bytes per step) and ``make_controller()``
builds a ReconfigController from a REGISTERED policy (default
``trainer_default``). The negotiated transport option set is exposed as
scoreable candidates (``transport_candidates``). Pass the controller to
``run()``.

Ranks agree. Every rank is a process of its own, and a decision that two
ranks make apart can differ (local step times, local clocks): then they enter
different collectives and hang. So negotiation's outcome is checked equal
on every rank before the first step; the straggler vote and the controller's
telemetry are rank 0's, broadcast; a 2PC outcome and the transport after a
controller tick are checked equal on every rank. A disagreement raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.comm.chunnels import (
    DEVICE_TRANSPORTS,
    TRANSPORTS,
    calibrate_cost_models,
    init_grad_states,
    transport_chunnels,
)
from repro_torch.configs.base import ModelConfig, ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.core import KVStore, rendezvous
from repro_torch.core.controller import (
    PolicyContext,
    ReconfigController,
    Rule,
    above,
    policy_rules,
    register_policy,
)
from repro_torch.core.cost import BYTES_FIRST, Candidate, CostModel, ScoredTarget, chunnel_cost
from repro_torch.core.telemetry import ConnTelemetry
from repro_torch.models.convert import fill_from_reference
from repro_torch.models.registry import model_class
from repro_torch.train import step as step_mod


@dataclass
class HostSpec:
    host_id: int
    offers: List[str]  # transport names this host supports, in preference order


@dataclass
class StragglerPolicy:
    window: int = 16
    slow_factor: float = 1.5
    fallback: str = "compressed_int8"  # negotiated transition target


@register_policy("trainer_default")
def trainer_default_policy(ctx: PolicyContext) -> List[Rule]:
    """The trainer's standard closed-loop policy, shipped through the plugin
    registry (applications register policies; core never hard-codes them):

      straggler_ratio > threshold   ⇒ ``mitigation`` (sync less often)
      f32 DCN rate    > byte budget ⇒ lighter wire format — an explicit
                                      ``budget_target``, or (when None) the
                                      fewest-DCN-bytes option scored over the
                                      negotiated transport candidates
      both signals healthy          ⇒ back to ``ctx.default``

    The budget/recovery rules read ``dcn_bytes_per_s_f32`` (what the DEFAULT
    transport WOULD cost right now) rather than the live byte rate, so
    committing a lighter wire format does not instantly disarm the very rule
    that selected it (a flap source hysteresis alone cannot fix).
    """
    p = ctx.params
    straggler_threshold = p.get("straggler_threshold", 1.5)
    recover_threshold = p.get("recover_threshold", 1.15)
    budget = p.get("dcn_budget_bytes_per_s")
    mitigation = p.get("mitigation", "localsgd")
    budget_target = p.get("budget_target", "compressed_int8")
    hold = p.get("hold", 2)
    recover_hold = p.get("recover_hold")
    default = ctx.default

    def recovered(s: dict) -> bool:
        if s.get("straggler_ratio", 1.0) >= recover_threshold:
            return False
        if budget is not None and s.get("dcn_bytes_per_s_f32", 0.0) > budget:
            return False
        return True

    rules = [
        Rule("straggler->mitigation", above("straggler_ratio", straggler_threshold),
             mitigation, hold=hold, priority=2),
    ]
    if budget is not None:
        if budget_target is not None:
            tgt = budget_target
        else:
            # scored argmin-DCN-bytes — but never the mitigation transport:
            # cost models only cover communication cost, and localsgd-style
            # mitigations win that contest by changing training semantics
            # (gradient staleness), which only the straggler rule may buy
            sync = [c for c in ctx.candidates if c.label != mitigation]
            tgt = ScoredTarget(sync or ctx.candidates, BYTES_FIRST)
        rules.append(
            Rule("dcn-budget->compressed", above("dcn_bytes_per_s_f32", budget),
                 tgt, hold=hold, priority=1))
    rules.append(
        Rule("recovered->default", recovered, default,
             hold=recover_hold if recover_hold is not None else 2 * hold,
             priority=0))
    return rules


class ReconfigurableTrainer:
    """One rank's trainer. ``mesh`` (``repro_torch.launch.mesh.Mesh``) names
    the rank's axes and device; every rank of the mesh builds the same
    trainer and calls the same methods in the same order. ``sharding``
    lays the state out on the mesh (``step.shardings_for``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        mesh,
        *,
        tcfg: TrainConfig = TrainConfig(),
        sharding: ShardingConfig = ShardingConfig(),
        transport: str = "xla",
        ckpt_dir: Optional[str] = None,
        store: Optional[KVStore] = None,
        hosts: Optional[Sequence[HostSpec]] = None,
        conn_id: str = "trainjob",
    ):
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.device = mesh.device
        self.tcfg = tcfg
        self.sharding = sharding
        self.store = store or KVStore()
        self.conn_id = conn_id
        self.hosts = list(hosts or [HostSpec(0, [transport])])
        self.transport_name = self._agree(self._negotiate_transport(), "the negotiated transport")
        # parameters are drawn by init_state (full, then cut to this rank's
        # blocks); the serving copies are never made. The model knows its
        # mesh, as the reference's ``build(cfg, mesh=mesh)``: the moe family
        # dispatches over it
        self.model = model_class(cfg)(cfg, device=self.device)
        self.model.mesh = mesh
        self.state_sh: Optional[step_mod.StateShardings] = None
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.step_times: List[float] = []
        self.reconfig_log: List[dict] = []
        self.telemetry = ConnTelemetry()
        self._param_bytes = 4 * sum(p.numel() for p in self.model.parameters())
        self._live_state = None  # current TrainState while a controller drives run()
        self._fleet_pub = None   # optional fleet signal plane (attach_fleet)
        # mesh-aware cost models: transport cost annotations divide DCN bytes
        # by the LIVE fast-axis width, not the NOMINAL_FAST guess
        calibrate_cost_models(mesh=mesh, fast_axis="data")
        self._build_step()

    # -- rank agreement ----------------------------------------------------------
    def _agree(self, value, what: str):
        """``value``, checked equal on every rank; raises if it is not."""
        if self.mesh.size == 1:
            return value
        seen: list = [None] * self.mesh.size
        dist.all_gather_object(seen, value)
        if any(v != seen[0] for v in seen):
            raise RuntimeError(f"ranks disagree on {what}: {seen}")
        return value

    def _decide(self, value):
        """Rank 0's ``value``, on every rank."""
        if self.mesh.size == 1:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _barrier(self) -> None:
        if self.mesh.size > 1:
            dist.barrier()

    # -- negotiation (multi-party, rendezvous §5.3) ----------------------------
    def _negotiate_transport(self) -> str:
        chosen = None
        for h in self.hosts:
            descs = [[{"name": t, "caps": [{"label": f"transport:{t}", "mode": "exact"}],
                       "upper": "grads", "lower": "unit", "multilateral": True}]
                     for t in h.offers]

            def compat(committed_desc, h=h):
                names = {c["name"] for c in committed_desc}
                for i, t in enumerate(h.offers):
                    if t in names:
                        return i
                return None

            member = f"host{h.host_id}"
            try:
                res = rendezvous.join(self.store, self.conn_id, member,
                                      h.offers, descs, compat)
                chosen = res.stack_desc[0]["name"]
            except ValueError:
                # §5.3: an incompatible joiner proposes a transition to a stack
                # it supports; existing members vote (accept iff they offer it)
                committed = False
                for idx, target in enumerate(h.offers):
                    epoch = rendezvous.propose_transition(
                        self.store, self.conn_id, member, target, descs[idx])
                    members = self.store.get(f"{self.conn_id}/members") or {}
                    for m in members:
                        voter = next((x for x in self.hosts
                                      if f"host{x.host_id}" == m), None)
                        ok = voter is not None and target in voter.offers
                        rendezvous.vote(self.store, self.conn_id, m, epoch, ok)
                    rendezvous.vote(self.store, self.conn_id, member, epoch, True)
                    # proposer must be a member for commit accounting
                    if rendezvous.try_commit(self.store, self.conn_id, epoch, 5.0):
                        committed = True
                        res = rendezvous.join(self.store, self.conn_id, member,
                                              h.offers, descs, compat)
                        chosen = res.stack_fp
                        break
                if not committed:
                    raise
        return chosen or "xla"

    # -- step construction -------------------------------------------------------
    def _build_step(self) -> None:
        self.chunnels = transport_chunnels(self.transport_name, self.mesh, self.device)
        self.state_sh = step_mod.shardings_for(self.model, self.mesh, self.sharding,
                                               self.chunnels)
        self._layout = step_mod.model_layout(self.state_sh)
        self.step_fn = step_mod.make_train_step(self.model, self.tcfg, self.chunnels, self.mesh,
                                                self.state_sh)
        # The next step pays the first-call costs (allocations, library
        # set-up): that blip is reconfiguration cost, not a data-plane signal
        # — keep it out of the step-time telemetry or it swamps the straggler
        # EWMAs (and would re-arm the very rule that caused the switch).
        self._skip_step_telemetry = True

    def _fresh_comm(self):
        """Zeroed chunnel state, this rank's blocks of it."""
        full = init_grad_states(self.chunnels, step_mod.grad_shapes(self.model))
        full = T.map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=self.device)
                     if isinstance(x, torch.Tensor) else x, full)
        return step_mod.place(full, self.state_sh.comm)

    def _set_params(self, full: Dict[str, torch.Tensor]) -> None:
        """The model's parameters set to this rank's blocks of ``full``, and
        its layout with them."""
        self.model.layout = None
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.data = self.state_sh.params[name].local(full[name]).to(self.device).clone()
        self.model.layout = self._layout

    def _full_params(self) -> None:
        """Full-shape parameters (contents unset) to draw or fill."""
        if self.model.layout is not None:
            for name, p in self.model.named_parameters():
                p.data = torch.empty(self.model.layout.shapes[name], device=self.device)
            self.model.layout = None

    def init_state(self, rng=0, *, params=None) -> step_mod.TrainState:
        """Parameters drawn from a ``torch.Generator`` seeded with ``rng``
        (the same on every rank), or set from the reference's tree
        ``params`` (nested dicts of numpy arrays); each rank keeps its blocks."""
        self._full_params()
        if params is not None:
            fill_from_reference(self.model, params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(int(rng))
            self.model.init_weights(gen)
        if self._layout is not None:
            self.model.shard(self._layout)
        st = step_mod.init_state(self.model, self.tcfg, self.state_sh)
        return st._replace(comm=self._fresh_comm())

    def gathered_state(self, state) -> step_mod.TrainState:
        """The state's full leaves (every rank calls it; each gets them)."""
        return step_mod.gathered(state, self.state_sh.state())

    def _relayout(self, state, old: step_mod.StateShardings):
        """``state``, laid out by ``old``, moved to the current shardings
        (the parameters and moments; chunnel state is made afresh)."""
        if [s.spec for s in T.leaves(old.state()[:2])] == [
                s.spec for s in T.leaves(self.state_sh.state()[:2])]:
            return state
        params = step_mod.gathered(state.params, old.params)
        opt = step_mod.gathered(state.opt, old.opt)
        self._set_params(params)
        return state._replace(params=dict(self.model.named_parameters()),
                              opt=step_mod.place(opt, self.state_sh.opt))

    # -- telemetry ------------------------------------------------------------------
    def _dcn_bytes_per_step(self) -> int:
        """Estimated cross-pod (DCN) gradient bytes per step under the active
        transport — the byte signal the controller budgets against. Coarse on
        purpose: one all-reduce ~ one param-sized exchange per rank, scaled by
        the transport's wire format / sync cadence."""
        if "pod" not in self.mesh.axis_names or self.mesh.shape["pod"] < 2:
            return 0
        pb = self._param_bytes
        name = self.transport_name
        if name in ("compressed_int8",):
            return pb // 4
        if name == "hier_compressed":
            return pb // (4 * max(self.mesh.shape.get("data", 1), 1))
        if name == "hierarchical":
            return pb // max(self.mesh.shape.get("data", 1), 1)
        if name == "localsgd":
            sync_every = next((ch.sync_every for ch in self.chunnels
                               if hasattr(ch, "sync_every")), 4)
            return pb // max(sync_every, 1)
        return pb  # xla / psum / ring: full f32 gradients every step

    def _record_step_telemetry(self, dt: float,
                               pod_times: Optional[Callable[[int, float], Dict[str, float]]],
                               step_idx: int) -> None:
        reports = (pod_times(step_idx, dt) if pod_times is not None
                   else {f"host{h.host_id}": dt for h in self.hosts})
        self.telemetry.record_step(reports)
        self.telemetry.record_wire(self._dcn_bytes_per_step())
        if self._fleet_pub is not None:
            self._fleet_pub.maybe_publish(
                extra={"transport": self.transport_name})

    def attach_fleet(self, fleet_id: str = "trainfleet", member: Optional[str] = None,
                     *, store: Optional[KVStore] = None, period_s: float = 0.0):
        """Join the fleet signal plane: publish this job's step telemetry
        into the rendezvous KV (``repro_torch.fleet.FleetPublisher``) so a
        ``FleetAggregator`` can fold it with other jobs' — cross-job DCN
        budgets, fleet-wide straggler views. ``reset_window=False`` because a
        local controller (``make_controller``) may also be snapshotting this
        telemetry; the published rates then cover its tick window. Defaults
        to this trainer's own rendezvous store; pass the shared one in
        multi-job deployments."""
        from repro_torch.fleet import FleetPublisher

        self._fleet_pub = FleetPublisher(
            store or self.store, fleet_id,
            member or f"host{self.hosts[0].host_id}:{self.conn_id}",
            self.telemetry, period_s=period_s, reset_window=False)
        return self._fleet_pub

    def _controller_snapshot(self, dt: float) -> dict:
        snap = self.telemetry.snapshot()
        # What the DEFAULT (f32 every-step) transport would currently cost:
        # budget/recovery rules compare against this so switching to a lighter
        # wire format doesn't immediately un-arm the rule that caused it.
        pod_active = "pod" in self.mesh.axis_names and self.mesh.shape["pod"] >= 2
        snap["dcn_bytes_per_s_f32"] = (self._param_bytes / max(dt, 1e-9)
                                       if pod_active else 0.0)
        return snap

    # -- training loop --------------------------------------------------------------
    def run(self, state, batches: Callable[[int], dict], num_steps: int,
            *, ckpt_every: int = 0, straggler: Optional[StragglerPolicy] = None,
            inject_slow: Optional[Callable[[int], float]] = None,
            controller: Optional[ReconfigController] = None,
            pod_times: Optional[Callable[[int, float], Dict[str, float]]] = None) -> tuple:
        """Run ``num_steps``. ``pod_times(step, own_dt) -> {pod: dt}`` models
        the heartbeat plane (other hosts reporting step times); ``controller``
        (from ``make_controller``) closes the loop — it observes the telemetry
        after every step and may commit a negotiated transport transition
        between steps. ``batches(step)`` gives the global batch."""
        metrics_hist: list = []
        try:
            return self._run_loop(state, batches, num_steps, metrics_hist,
                                  ckpt_every, straggler, inject_slow,
                                  controller, pod_times)
        finally:
            # even on a mid-run exception, don't pin params/opt state forever
            self._live_state = None

    def _run_loop(self, state, batches, num_steps, metrics_hist, ckpt_every,
                  straggler, inject_slow, controller, pod_times) -> tuple:
        for _ in range(num_steps):
            step_idx = int(state.step)
            batch = batches(step_idx)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)  # metrics are host floats
            dt = time.perf_counter() - t0
            if inject_slow is not None:
                extra = inject_slow(step_idx)
                if extra > 0:
                    time.sleep(extra)
                    dt += extra
            self.step_times.append(dt)
            metrics_hist.append(dict(metrics))
            if ckpt_every and self.ckpt and (step_idx + 1) % ckpt_every == 0:
                self._save(step_idx + 1, state, asynchronous=True)
            if straggler is not None:
                state = self._maybe_mitigate(state, straggler)
            if self._skip_step_telemetry:
                self._skip_step_telemetry = False  # first step: blip, not signal
            else:
                self._record_step_telemetry(dt, pod_times, step_idx)
                if controller is not None:
                    self._live_state = state
                    controller.tick(self._decide(self._controller_snapshot(dt)))
                    self._agree(self.transport_name, "the transport after a controller tick")
                    state = self._live_state  # controller_switch may have migrated it
        if self.ckpt:
            self.ckpt.wait()
        self._barrier()
        return state, metrics_hist

    # -- straggler mitigation via reconfiguration -----------------------------------
    def _maybe_mitigate(self, state, pol: StragglerPolicy):
        if self.transport_name == pol.fallback or len(self.step_times) < 2 * pol.window:
            return state
        recent = np.median(self.step_times[-pol.window:])
        base = np.median(self.step_times[: pol.window])
        if self._decide(bool(recent > pol.slow_factor * base)):
            state = self.reconfigure(state, pol.fallback)
        return state

    def reconfigure(self, state, new_transport: str):
        """Negotiated transition (2PC via rendezvous) + state migration +
        step rebuilt."""
        desc = [{"name": new_transport,
                 "caps": [{"label": f"transport:{new_transport}", "mode": "exact"}],
                 "upper": "grads", "lower": "unit", "multilateral": True}]
        epoch = rendezvous.propose_transition(
            self.store, self.conn_id, "host0", new_transport, desc)
        for h in self.hosts:  # peers vote their offer lists; the proposer
            # (host0, who initiated this transition) consents by proposing —
            # a peer that doesn't offer the target vetoes the whole switch
            ok = new_transport in h.offers or h.host_id == 0
            rendezvous.vote(self.store, self.conn_id, f"host{h.host_id}", epoch, ok)
        committed = rendezvous.try_commit(self.store, self.conn_id, epoch, timeout_s=5.0)
        self._agree((new_transport, committed), "the outcome of a 2PC transition")
        if not committed:
            self.reconfig_log.append({"to": new_transport, "committed": False})
            return state
        old = self.transport_name
        old_sh = self.state_sh
        self.transport_name = new_transport
        self._build_step()
        # state migration: params/opt carry over (laid out again where the
        # shardings changed); chunnel state re-initialized for the new wire
        # format (EF residuals cannot survive a format change)
        state = self._relayout(state, old_sh)._replace(comm=self._fresh_comm())
        self.reconfig_log.append({"from": old, "to": new_transport, "committed": True,
                                  "at_step": int(state.step)})
        return state

    # -- closed-loop controller -------------------------------------------------------
    def controller_switch(self, target: str) -> bool:
        """Switch callback for a ReconfigController: rendezvous-negotiated
        transition + state migration + step rebuilt, applied to the live
        state."""
        assert self._live_state is not None, "controller_switch outside run()"
        before = len(self.reconfig_log)
        self._live_state = self.reconfigure(self._live_state, target)
        return (len(self.reconfig_log) > before
                and self.reconfig_log[-1]["committed"])

    def transport_candidates(self, *, include_mitigations: bool = False) -> List[Candidate]:
        """The negotiated transport option set as scoreable candidates: every
        transport ALL hosts offer (host0's preference order), each annotated
        with its chunnel's cost model so ScoredTargets can rank them. Targets
        stay the transport *names* — ``controller_switch`` turns the chosen
        name into a rendezvous-negotiated transition.

        Transports that trade gradient freshness for communication (chunnel
        ``exact_sync = False``, e.g. localsgd) are EXCLUDED by default: their
        cost models honestly win the comm-cost contest, so any scoring policy
        (``cost_aware``, a scored byte budget) would adopt them steady-state
        and silently change training semantics. Mitigation rules name them
        directly by label instead; pass ``include_mitigations=True`` only if
        the policy knowingly accepts staleness."""
        common = [t for t in self.hosts[0].offers
                  if all(t in h.offers for h in self.hosts)]
        out = []
        for t in common:
            if t not in TRANSPORTS:
                out.append(Candidate(t, CostModel(), t))
                continue
            # only the cost model is read: no kernel runs on this instance
            ch = TRANSPORTS[t](**({"device": "cpu"} if t in DEVICE_TRANSPORTS else {}))
            if not include_mitigations and not getattr(ch, "exact_sync", True):
                continue
            out.append(Candidate(t, chunnel_cost(ch), t))
        return out

    def make_controller(
        self,
        *,
        policy: str = "trainer_default",
        policy_params: Optional[dict] = None,
        straggler_threshold: float = 1.5,
        recover_threshold: float = 1.15,
        dcn_budget_bytes_per_s: Optional[float] = None,
        mitigation: str = "localsgd",
        budget_target: Optional[str] = "compressed_int8",
        default: Optional[str] = None,
        hold: int = 2,
        recover_hold: Optional[int] = None,
        cooldown_s: float = 0.0,
        now: Callable[[], float] = time.monotonic,
    ) -> ReconfigController:
        """Build the controller ``run()`` ticks once per step, by
        instantiating a REGISTERED policy against this trainer's negotiated
        option set (see ``trainer_default_policy`` for the standard rules;
        pass ``policy=`` to run any other registered policy, e.g.
        ``cost_aware`` with ``policy_params={"objective": ...}``).

        The keyword knobs feed the policy's params (``policy_params`` wins on
        conflict). Whatever target a rule resolves to must appear in every
        PEER host's offers or the rendezvous vote aborts the transition (the
        proposing host consents by proposing) — policy cannot override the
        peers' negotiation. Every rank ticks its controller with rank 0's
        snapshot; a ``cooldown_s`` read from each rank's own clock ``now``
        can still part them, which ``run`` turns into an error."""
        params = {
            "straggler_threshold": straggler_threshold,
            "recover_threshold": recover_threshold,
            "dcn_budget_bytes_per_s": dcn_budget_bytes_per_s,
            "mitigation": mitigation,
            "budget_target": budget_target,
            "hold": hold,
            "recover_hold": recover_hold,
        }
        params.update(policy_params or {})
        ctx = PolicyContext(candidates=self.transport_candidates(),
                            default=default or self.transport_name,
                            params=params)
        rules = policy_rules(policy, ctx)
        return ReconfigController(
            rules, self.controller_switch, lambda: self.transport_name,
            cooldown_s=cooldown_s, now=now)

    # -- checkpoint/restart -----------------------------------------------------------
    def _save(self, step: int, state, *, asynchronous: bool = False) -> None:
        """Every rank gathers the state's full leaves, rank 0 writes them: a
        checkpoint holds the logical state, whatever the mesh (two writers
        would race on the rename)."""
        full = self.gathered_state(state)
        if self.mesh.rank == 0:
            self.ckpt.save(step, full, asynchronous=asynchronous)

    def save(self, state, step: Optional[int] = None):
        assert self.ckpt is not None
        self._save(step if step is not None else int(state.step), state)
        self._barrier()

    def restore(self, like=None, *, step: Optional[int] = None):
        """The checkpoint at ``step`` (the latest by default), saved on any
        mesh, as a state laid out on this one: parameters copied into the
        model, the rest on the device. Every rank reads it after rank 0's
        writes have finished."""
        assert self.ckpt is not None
        if self.mesh.rank == 0:
            self.ckpt.wait()
        self._barrier()
        like = like if like is not None else step_mod.state_shapes(
            self.model, self.chunnels, self.tcfg)
        tree, at = self.ckpt.restore(like, step=step, shardings=self.state_sh.state())
        self.model.layout = None
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.data = tree.params[name].to(self.device)
        self.model.layout = self._layout
        to_dev = lambda x: x.to(self.device) if isinstance(x, torch.Tensor) else x  # noqa: E731
        return tree._replace(params=dict(self.model.named_parameters()),
                             opt=T.map(to_dev, tree.opt), comm=T.map(to_dev, tree.comm)), at
