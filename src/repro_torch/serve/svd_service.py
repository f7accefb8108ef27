"""Streaming rank-1 SVD-update service: async micro-batched engine flushes,
checkpointable to disk (DESIGN.md §9), in PyTorch.

Counterpart of ``repro.serve.svd_service``.  Many concurrent streams each own
a truncated ``SvdState``; the service queues their rank-1 pairs and
structured events and flushes *one batched engine call* per geometry group
and round:

    svc = SvdService(max_batch=64, policy=UpdatePolicy(method="fused"))
    svc.register("user-1", api.SvdState.from_dense(m1, rank=8))   # on the card
    svc.enqueue("user-1", a, b)        # cheap: just queues
    svc.enqueue_op("user-1", RankK(u_blk, v_blk))   # structured: rank-k bucket
    svc.flush()                        # one batched truncated update
    svc.save("/ckpts/svd", step=1)     # versioned snapshot; survives restart
    step, svc = SvdService.restore("/ckpts/svd")   # device="cuda" by default

The reference's rules hold unchanged, so that both packages batch, pad,
record and snapshot alike:

* per-stream FIFO order; a round takes at most one pair per stream (or, with
  ``flush_round(max_depth=k)``, a power-of-two-floored run of pairs as one
  rank-k column); ``enqueue`` auto-flushes once ``max_batch`` streams have a
  pending head; batches pad to powers of two by repeating the last state
  with zero pairs (``_bucket``); rounds group by ``truncated_geometry`` and
  depth;
* structured events: ``RankK`` / ``DenseDelta`` / ``Compose`` of them lower
  into pairs at enqueue, appends, downdates and ``Decay`` stay whole and run
  through the planner at flush, and a ``Sparse`` event stays whole (its COO
  leaves ride snapshots bitwise, int32 indices stay int32) and expands into
  its ``rank`` pairs at the head of a round;
* the engine is resolved without geometry (``_engine_for``), so ``auto``
  runs the phase chain (``direct``); ``method="fused"`` takes kernel B and
  ``"pallas"`` kernel C on the card;
* every flushed ``(kind, geometry)`` enters the warmed set; snapshots carry
  it and ``restore`` warms each entry (``api.warmup``,
  ``updates.warmup_sketch``) before it returns.

Async rounds are CUDA events: a dispatched round records an event on the
current stream and the host goes on enqueueing; ``max_in_flight`` bounds the
rounds outstanding (0 = synchronous), and the next round first waits for the
oldest (backpressure, counted in ``backpressure_waits``).  On the CPU every
round is ready at once.  Inputs reach the card once a round: a group's
host-side pairs are stacked on the host and copied in one transfer.

Snapshots (``ServiceSnapshot``, version 7) keep the reference's leaf order
and aux spec and go through ``train.checkpoint``'s shared on-disk layout, so
a snapshot written by either package restores in the other.

Placement: ``policy.mesh`` (a ``dist.mesh.Mesh``) spreads every round's
batch over the mesh's ``batch_axis`` through the engine's mesh rows.  The
mesh is runtime placement, not state: snapshots record only that one was set
(``had_mesh``); pass ``mesh=`` (or a full ``policy=``) to ``restore`` on the
new topology.  Unlike the reference, mesh rounds enter the warmed set too,
and a restore under a mesh warms each entry's per-slice geometry.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.api import SvdState, UpdatePolicy, as_state
from repro_torch.api.policy import as_torch_dtype
from repro_torch.api.state import resolve_device
from repro_torch.api.update import engine_from_key, warmup as _api_warmup
from repro_torch.core.engine import (
    SvdEngine,
    group_indices,
    stack_trees,
    truncated_geometry,
    unstack_tree,
)
from repro_torch.core.svd_update import TruncatedSvd
from repro_torch.dist.merge import merge_tree
from repro_torch import _tree
from repro_torch.train import checkpoint as _checkpoint
from repro_torch.updates import ops as _ops
from repro_torch.updates import planner as _planner
from repro_torch.updates import sketch as _sketch

__all__ = [
    "SNAPSHOT_VERSION",
    "ServiceSnapshot",
    "SvdService",
    "SvdServiceStats",
]

# v4 and v6 are the reference's fleet formats on the shared version line;
# v7 added the ``obs_metrics`` registry capture.
SNAPSHOT_VERSION = 7
_SNAPSHOT_FORMAT = "repro.serve.ServiceSnapshot"

# UpdatePolicy fields a snapshot records verbatim (``mesh`` names live
# devices of one process and is never recorded)
_POLICY_SPEC_FIELDS = (
    "method",
    "fmm_p",
    "sign_fix",
    "deflate_rtol",
    "precision",
    "storage_dtype",
    "sketch_oversample",
    "sketch_power_iters",
    "batch_axis",
    "truncate_to",
    "health_every",
)

# policy fields added after SNAPSHOT_VERSION was first minted: older
# snapshots lack them, and restore takes each field's UpdatePolicy default
_POLICY_SPEC_DEFAULTS = {
    "storage_dtype": None,
    "sketch_oversample": 8,
    "sketch_power_iters": 1,
    "health_every": None,
}


def _dtype_name(dt) -> str:
    """numpy's name of a dtype (``"float64"``, never ``"torch.float64"``)."""
    return str(dt).rsplit(".", 1)[-1]


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _obs_rows(rows) -> tuple:
    """Re-hash registry snapshot rows after a JSON round trip."""
    return tuple(
        (name, tuple((str(k), str(v)) for k, v in labels), kind, state)
        for name, labels, kind, state in rows
    )


def _policy_spec(policy: UpdatePolicy) -> dict:
    spec = {f: getattr(policy, f) for f in _POLICY_SPEC_FIELDS}
    if spec["storage_dtype"] is not None:
        spec["storage_dtype"] = _dtype_name(spec["storage_dtype"])
    spec["had_mesh"] = policy.mesh is not None
    return spec


def _policy_from_spec(spec: dict, mesh=None) -> UpdatePolicy:
    return UpdatePolicy(mesh=mesh, **{f: spec.get(f, _POLICY_SPEC_DEFAULTS.get(f))
                                      for f in _POLICY_SPEC_FIELDS})


def _host(x) -> np.ndarray:
    """A vector or matrix as a numpy array (device tensors are copied back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on_device(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def _stack_to(vecs: list, dt: torch.dtype, device: torch.device) -> torch.Tensor:
    """Stack same-shape vectors (or lists of them: rank-k columns) into one
    tensor on ``device`` in ``dt``.  Host-side inputs are stacked and cast on
    the host and reach the device in ONE copy; when some already live on the
    device, the stack is built there."""
    flat = [y for x in vecs for y in (x if isinstance(x, list) else [x])]
    if not any(_on_device(x) for x in flat):
        host = np.stack([np.stack([_host(y) for y in x]) if isinstance(x, list) else _host(x)
                         for x in vecs])
        host = np.ascontiguousarray(host.astype(_np_dtype(dt), copy=False))
        return torch.from_numpy(host).to(device, non_blocking=True)

    def dev(x):
        if isinstance(x, list):
            return torch.stack([dev(y) for y in x])
        return torch.as_tensor(x).to(device=device, dtype=dt, non_blocking=True)

    return torch.stack([dev(x) for x in vecs])


def _vec(x, st: SvdState) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=st.device, dtype=st.dtype)
    return torch.as_tensor(np.asarray(x)).to(device=st.device, dtype=st.dtype)


def _dtype_of(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype


def _state_to(st, device: torch.device) -> SvdState:
    return SvdState(*(torch.as_tensor(x).to(device) if not isinstance(x, torch.Tensor)
                      else x.to(device) for x in (st.u, st.s, st.v)))


@dataclass
class SvdServiceStats:
    enqueued: int = 0
    applied: int = 0
    flushes: int = 0
    rounds: int = 0          # batched engine calls (one per geometry group)
    max_batch: int = 0       # largest batch (incl. bucket padding) dispatched
    backpressure_waits: int = 0   # rounds that had to wait for an older one
    in_flight_peak: int = 0       # most rounds ever outstanding at once
    ops_applied: int = 0          # structured (non-pair) events applied
    scan_rounds: int = 0          # depth-batched (rank-k) engine calls
    max_depth: int = 0            # deepest rank-k column ever dispatched


@dataclasses.dataclass(frozen=True)
class ServiceSnapshot:
    """Versioned, self-describing capture of a whole ``SvdService``.

    Its leaves, in the reference's pytree order, are every stream's
    ``(u, s, v)``, then its pending pairs as two ``(k_i, m)`` / ``(k_i, n)``
    stacks, then its pending structured events' own leaves (``pending_ops``,
    with ``pending_order`` one ``"p"``/``"o"`` string per stream recording
    how pairs and ops interleave).  Everything else (stream ids, the policy
    spec, the batching config, the stats, the warmed set, the obs rows) is
    structure, mirrored into the JSON ``aux`` spec so that a fresh process
    rebuilds the structure before loading a leaf (``skeleton``).

    Versions: v1 snapshots (all-pair FIFOs, nothing warmed) load with the
    empty defaults; v2 added ops and the warmed set, v3 ``Sparse`` events
    and the sketch knobs, v5 downdates, v7 ``obs_metrics`` — none changed
    the leaf layout, so every older version loads unchanged; a newer version
    is refused.
    """

    tree_fields = ("states", "pending_a", "pending_b", "pending_ops")

    states: tuple          # tuple[SvdState, ...] per stream
    pending_a: tuple       # tuple[(k_i, m_i) array, ...] queued a-vectors, FIFO
    pending_b: tuple       # tuple[(k_i, n_i) array, ...] queued b-vectors, FIFO
    pending_ops: tuple = ()   # tuple[tuple[UpdateOp, ...], ...] per stream, FIFO
    version: int = SNAPSHOT_VERSION
    stream_ids: tuple = ()
    policy_spec: tuple = ()   # tuple of (field, value) pairs
    max_batch: int = 64
    pad_to_bucket: bool = True
    max_in_flight: int = 2
    stats: tuple = ()         # SvdServiceStats counters as (name, value) pairs
    pending_order: tuple = () # per stream: "p"/"o" markers in FIFO order
    warmed: tuple = ()        # (kind, batch, m, n, rank, dtype_str) tuples
    obs_metrics: tuple = ()   # MetricsRegistry.snapshot() rows (v7+)

    def aux(self) -> dict:
        """The JSON spec persisted next to the arrays (checkpoint ``aux=``)."""
        return {
            "format": _SNAPSHOT_FORMAT,
            "version": self.version,
            "stream_ids": list(self.stream_ids),
            "policy": dict(self.policy_spec),
            "max_batch": self.max_batch,
            "pad_to_bucket": self.pad_to_bucket,
            "max_in_flight": self.max_in_flight,
            "stats": dict(self.stats),
            "pending_order": list(self.pending_order),
            "pending_ops": [
                [_ops.spec_to_json(op.spec()) for op in stream_ops]
                for stream_ops in self.pending_ops
            ],
            "warmed": [list(w) for w in self.warmed],
            "obs_metrics": [list(r) for r in self.obs_metrics],
        }

    @classmethod
    def skeleton(cls, aux: dict) -> "ServiceSnapshot":
        """A structure-only snapshot (placeholder leaves) built from an aux
        spec: what ``load`` fills with the restored leaves.  v1 aux specs get
        the empty defaults (no extra leaves)."""
        n = len(aux["stream_ids"])
        op_specs = aux.get("pending_ops", [[] for _ in range(n)])
        return cls(
            states=tuple(SvdState(u=0.0, s=0.0, v=0.0) for _ in range(n)),
            pending_a=tuple(0.0 for _ in range(n)),
            pending_b=tuple(0.0 for _ in range(n)),
            pending_ops=tuple(
                tuple(_ops.skeleton_from_spec(_ops.spec_from_json(sp)) for sp in sps)
                for sps in op_specs
            ),
            version=SNAPSHOT_VERSION,
            stream_ids=tuple(aux["stream_ids"]),
            policy_spec=tuple((k, v) for k, v in aux["policy"].items()),
            max_batch=aux["max_batch"],
            pad_to_bucket=aux["pad_to_bucket"],
            max_in_flight=aux["max_in_flight"],
            stats=tuple((k, v) for k, v in aux["stats"].items()),
            pending_order=tuple(aux.get("pending_order", ())),
            warmed=tuple(tuple(w) for w in aux.get("warmed", ())),
            obs_metrics=_obs_rows(aux.get("obs_metrics", ())),
        )

    def leaves(self) -> list:
        """The snapshot's leaves in the reference's pytree order."""
        return _tree.tree_leaves(self)

    @classmethod
    def from_leaves(cls, leaves, aux: dict) -> "ServiceSnapshot":
        """The snapshot an aux spec describes, with ``leaves`` (in the
        reference's order) as its data."""
        return _tree.tree_unflatten(cls.skeleton(aux), list(leaves))

    def save(self, ckpt_dir, step: int, *, keep: int = 3):
        """Persist through ``train.checkpoint`` (atomic + checksummed)."""
        return _checkpoint.save(ckpt_dir, step, self, keep=keep, aux=self.aux())

    @classmethod
    def load(cls, ckpt_dir, step: int | None = None) -> tuple[int, "ServiceSnapshot"]:
        """Load ``(step, snapshot)`` from a checkpoint directory.  Leaves come
        back exactly as saved (numpy, bitwise, uncast); they reach a device
        in ``SvdService.from_snapshot``."""
        step, aux = _checkpoint.load_aux(ckpt_dir, step)
        if aux is None or aux.get("format") != _SNAPSHOT_FORMAT:
            raise ValueError(
                f"checkpoint at step {step} is not a ServiceSnapshot "
                f"(aux format: {None if aux is None else aux.get('format')!r})")
        if aux["version"] > SNAPSHOT_VERSION:
            raise ValueError(f"snapshot version {aux['version']} is newer than this build "
                             f"understands (<= {SNAPSHOT_VERSION})")
        _, leaves = _checkpoint.restore(ckpt_dir, None, step)
        return step, cls.from_leaves(leaves, aux)


def _bucket(b: int, cap: int) -> int:
    """Smallest power of two >= b (clamped to cap): bounds the geometries."""
    p = 1
    while p < b:
        p <<= 1
    return min(p, max(cap, 1))


def _depth_bucket(run: int, cap: int) -> int:
    """Largest power of two <= min(run, cap): the rank-k depth a stream's
    run of consecutive pairs dispatches as (floored, so a stream never pads
    its own column with no-op pairs)."""
    run = min(run, max(cap, 1))
    p = 1
    while p * 2 <= run:
        p <<= 1
    return p


def _is_ready(event) -> bool:
    return True if event is None else event.query()


class SvdService:
    """Async micro-batching front end over the batched truncated-update
    engine, checkpointable via ``snapshot``/``save``/``restore``."""

    def __init__(
        self,
        *,
        engine: SvdEngine | None = None,
        method: str = "direct",
        max_batch: int = 64,
        pad_to_bucket: bool = True,
        max_in_flight: int = 2,
        policy: UpdatePolicy | None = None,
    ):
        if max_in_flight < 0:
            raise ValueError(f"max_in_flight must be >= 0; got {max_in_flight}")
        self.policy = policy if policy is not None else UpdatePolicy(method=method)
        self.engine = engine            # explicit override; None -> policy-derived
        self.max_batch = max_batch
        self.pad_to_bucket = pad_to_bucket
        # 0 = synchronous (every round waits before returning); 1 = single
        # buffer; 2 = double buffering (default)
        self.max_in_flight = max_in_flight
        self.stats = SvdServiceStats()
        self._streams: OrderedDict[str, SvdState] = OrderedDict()
        # FIFO of events per stream, each carrying a visibility token:
        # ("pair", a, b, token) | ("op", UpdateOp, token)
        self._pending: dict[str, deque] = {}
        self._eff_shape: dict[str, tuple] = {}   # post-queue (m, n) per stream
        # per dispatched round: (CUDA event or None, tokens the round carried)
        self._in_flight: deque[tuple] = deque()
        self._warmed: set[tuple] = set()         # (kind, batch, m, n, r, dtype)
        self._next_token = 0
        self._visible: list[int] = []
        self._lock = threading.RLock()
        self._obs_labels: dict = {}
        self._health: "_obs.HealthMonitor | None" = None
        self._stat_gauges: tuple | None = None   # cached (field, gauge) handles

    # -- visibility tokens ---------------------------------------------------
    #
    # Every enqueued event gets a token; it becomes visible when the round
    # that applied it has retired.  Tokens are runtime state, never
    # snapshotted.

    def _new_token(self) -> int:
        t = self._next_token
        self._next_token += 1
        return t

    def take_visible(self) -> list[int]:
        """Drain and return tokens whose updates are now visible (reaps
        ready rounds first, without blocking)."""
        with self._lock:
            self._reap_ready()
            out, self._visible = self._visible, []
            return out

    def _engine_for(self, rank: int) -> SvdEngine:
        if self.engine is not None:
            return self.engine
        return engine_from_key(self.policy, rank + 1)

    def _record_warm(self, kind: str, batch, m: int, n: int, r: int, dt) -> None:
        """Track the (kind, geometry) set flushes have run, for restore."""
        self._warmed.add((kind, batch, m, n, r, _dtype_name(dt)))

    # -- stream lifecycle ---------------------------------------------------

    def register(self, stream_id: str, state) -> None:
        """Create (or replace) a stream with its current truncated SVD (an
        ``SvdState`` or ``TruncatedSvd`` of tensors; the stream runs where
        they live).  Replacing drops the stream's pending events."""
        with self._lock:
            st = as_state(state)
            if not isinstance(st.u, torch.Tensor):
                raise TypeError("register takes a state of tensors; build it with "
                                "SvdState.from_factors(..., device=...)")
            self._streams[stream_id] = SvdState(u=st.u, s=st.s, v=st.v)
            self._pending[stream_id] = deque()
            self._eff_shape[stream_id] = (st.m, st.n)

    def evict(self, stream_id: str) -> SvdState:
        """Drop a stream and return its state with its OWN queue applied."""
        with self._lock:
            state = self._streams[stream_id]
            queue = self._pending.get(stream_id, deque())
            while queue:
                state = self._apply_event(state, queue[0])
                self._token_visible(queue.popleft())
            del self._streams[stream_id]
            self._pending.pop(stream_id, None)
            self._eff_shape.pop(stream_id, None)
            return state

    def _token_visible(self, ev: tuple) -> None:
        if ev[-1] is not None:
            self._visible.append(ev[-1])

    def _apply_one(self, state: SvdState, a, b) -> SvdState:
        eng = self._engine_for(state.rank)
        self._record_warm("trunc", None, state.m, state.n, state.rank, state.dtype)
        t = eng.update_truncated(TruncatedSvd(state.u, state.s, state.v),
                                 _vec(a, state), _vec(b, state))
        return SvdState(u=t.u, s=t.s, v=t.v)

    def _apply_event(self, state: SvdState, ev: tuple) -> SvdState:
        """Apply one FIFO event to one stream's state; callers pop it after
        this returns (failure-atomic)."""
        if ev[0] == "pair":
            out = self._apply_one(state, ev[1], ev[2])
            self.stats.applied += 1
            return out
        op = ev[1]
        self._record_op_warm(state, op)
        out = _planner.apply(state, op, self.policy)
        self.stats.applied += 1
        self.stats.ops_applied += 1
        return SvdState(u=out.u, s=out.s, v=out.v)

    def _record_op_warm(self, state: SvdState, op) -> None:
        """Record every single-update geometry an op's schedule dispatches
        plus every sketch site it runs, so restore warms those too."""
        m, n = state.m, state.n
        for sm, sn, sk, snnz in _planner._sketch_sites(op.spec(), m, n)[0]:
            kind = "sketch_dense" if snnz is None else "sketch_sparse"
            self._record_warm(kind, snnz, sm, sn, sk, state.dtype)
        for step in _planner.lower(op, state, self.policy):
            if step[0] == "pad_rows":
                m += step[1]
            elif step[0] == "pad_cols":
                n += step[1]
            elif step[0] == "drop_rows":
                m -= len(step[1])
            elif step[0] == "drop_cols":
                n -= len(step[1])
            elif step[0] in ("rank1", "rank1_scan"):
                self._record_warm("trunc", None, m, n, state.rank, state.dtype)

    def _effective_shape(self, stream_id: str) -> tuple[int, int]:
        """Stream geometry AFTER every queued event (appends grow it)."""
        return self._eff_shape[stream_id]

    def state(self, stream_id: str) -> SvdState:
        """Current state; pending (unflushed) events are NOT yet applied.  Its
        tensors may still be computing on the card (reading them waits)."""
        with self._lock:
            return self._streams[stream_id]

    def settle(self, stream_ids) -> list[SvdState]:
        """Apply each named stream's OWN queued events and return the
        settled states in ``stream_ids`` order."""
        with self._lock:
            states = []
            for sid in stream_ids:
                state = self._streams[sid]
                queue = self._pending[sid]
                while queue:
                    state = self._apply_event(state, queue[0])
                    self._token_visible(queue.popleft())
                self._streams[sid] = state
                states.append(state)
            return states

    def merge_streams(self, stream_ids, *, target: str | None = None,
                      rank: int | None = None) -> SvdState:
        """Merge several streams (row blocks, in ``stream_ids`` order) into one
        truncated SVD with ``dist.merge.merge_tree``, after applying each
        one's own pending events; with ``target`` the result is registered as
        a new stream."""
        states = self.settle(stream_ids)
        merged = merge_tree(states, rank=rank, engine=self.engine, policy=self.policy)
        if target is not None:
            with self._lock:
                self.register(target, merged)
        return merged

    def pending(self, stream_id: str | None = None) -> int:
        with self._lock:
            if stream_id is not None:
                return len(self._pending[stream_id])
            return sum(len(q) for q in self._pending.values())

    def in_flight(self) -> int:
        """Dispatched-but-unretired flush rounds (after reaping ready ones)."""
        with self._lock:
            self._reap_ready()
            return len(self._in_flight)

    # -- the hot path -------------------------------------------------------

    def enqueue(self, stream_id: str, a, b) -> int:
        """Queue one rank-1 perturbation ``a b^T`` (numpy arrays or tensors)
        for a stream; returns its visibility token.  Auto-flushes when
        ``max_batch`` streams have a pending head."""
        with self._lock:
            if stream_id not in self._streams:
                raise KeyError(f"unknown stream {stream_id!r}; register() first")
            m, n = self._effective_shape(stream_id)
            if tuple(a.shape) != (m,) or tuple(b.shape) != (n,):
                raise ValueError(
                    f"pair shapes {tuple(a.shape)}/{tuple(b.shape)} do not match stream "
                    f"{stream_id!r} geometry ({m},)/({n},)")
            token = self._new_token()
            self._pending[stream_id].append(("pair", a, b, token))
            self.stats.enqueued += 1
            self._maybe_autoflush()
            return token

    def enqueue_op(self, stream_id: str, op: "_ops.UpdateOp") -> int:
        """Queue one structured perturbation (a ``repro_torch.updates`` op);
        returns the token of its LAST lowered event."""
        with self._lock:
            if stream_id not in self._streams:
                raise KeyError(f"unknown stream {stream_id!r}; register() first")
            if not isinstance(op, _ops.UpdateOp):
                raise TypeError(f"enqueue_op takes a repro_torch.updates op; got {type(op)}")
            m, n = self._effective_shape(stream_id)
            events, out_shape = self._lower_op_events(op, m, n, stream_id)
            events = [ev + (self._new_token(),) for ev in events]
            self._pending[stream_id].extend(events)
            self._eff_shape[stream_id] = out_shape
            self.stats.enqueued += len(events)
            self._maybe_autoflush()
            return events[-1][-1]

    def _lower_op_events(self, op, m: int, n: int, sid: str) -> tuple[list, tuple]:
        """Lower an op into FIFO events at (m, n); returns ``(events, geometry
        after the op)``."""
        if isinstance(op, _ops.Compose):
            events: list = []
            for child in op.ops:
                sub, (m, n) = self._lower_op_events(child, m, n, sid)
                events.extend(sub)
            return events, (m, n)
        if isinstance(op, _ops.RankK):
            u = op.u if isinstance(op.u, torch.Tensor) else np.asarray(op.u)
            v = op.v if isinstance(op.v, torch.Tensor) else np.asarray(op.v)
            if tuple(u.shape) != (m, op.k) or tuple(v.shape) != (n, op.k):
                raise ValueError(f"RankK factors {tuple(u.shape)}/{tuple(v.shape)} do not match "
                                 f"stream {sid!r} geometry ({m},{op.k})/({n},{op.k})")
            return [("pair", u[:, i], v[:, i]) for i in range(op.k)], (m, n)
        if isinstance(op, _ops.DenseDelta):
            if tuple(op.delta.shape) != (m, n):
                raise ValueError(f"DenseDelta shape {tuple(op.delta.shape)} does not match "
                                 f"stream {sid!r} geometry ({m}, {n})")
            # the planner's shared range-finder: serve and plan never drift
            dt = _dtype_of(op.delta)
            self._record_warm("sketch_dense", None, m, n, op.rank, dt)
            du, ds, dv = _planner.op_low_rank_factors(
                op, m, n, self.policy, device=self._streams[sid].device, dtype=dt)
            return [("pair", du[:, i] * ds[i], dv[:, i]) for i in range(op.rank)], (m, n)
        if isinstance(op, _ops.Sparse):
            if not (tuple(op.rows.shape) == tuple(op.cols.shape) == tuple(op.vals.shape)
                    and len(op.vals.shape) == 1):
                raise ValueError(
                    f"Sparse coordinates must be matching 1-D (nnz,) arrays; got "
                    f"{tuple(op.rows.shape)}/{tuple(op.cols.shape)}/{tuple(op.vals.shape)} "
                    f"for stream {sid!r}")
            # queued WHOLE (snapshots carry the COO leaves bitwise); the round
            # that reaches it expands it into its rank pairs
            return [("op", op)], (m, n)
        if isinstance(op, (_ops.AppendRows, _ops.AppendCols)):
            width_ok = (
                (op.rows.shape[1] == n if op.rows is not None else op.v.shape[0] == n)
                if isinstance(op, _ops.AppendRows)
                else (op.cols.shape[0] == m if op.cols is not None else op.u.shape[0] == m)
            )
            if not width_ok:
                raise ValueError(f"{type(op).__name__} block does not match stream {sid!r} "
                                 f"geometry ({m}, {n})")
            return [("op", op)], op.out_shape(m, n)
        if isinstance(op, (_ops.RemoveRows, _ops.RemoveCols, _ops.Window)):
            # reject bad indices HERE: at flush a poisoned event would stay
            # queued forever under the failure-atomicity contract
            if isinstance(op, _ops.RemoveRows) and op.idx[-1] >= m:
                raise ValueError(f"RemoveRows{op.idx} out of range for stream {sid!r} "
                                 f"geometry ({m}, {n})")
            if isinstance(op, _ops.RemoveCols) and op.idx[-1] >= n:
                raise ValueError(f"RemoveCols{op.idx} out of range for stream {sid!r} "
                                 f"geometry ({m}, {n})")
            out = op.out_shape(m, n)
            rank = self._streams[sid].rank
            if rank > min(out):
                raise ValueError(f"{type(op).__name__} shrinks stream {sid!r} to {out}, "
                                 f"below its rank {rank} — truncate first")
            return [("op", op)], out
        return [("op", op)], op.out_shape(m, n)   # Decay and future scalars

    def _expand_sparse_head(self, sid: str) -> None:
        """Lower the ``Sparse`` op at the head of ``sid``'s queue into its
        ``rank`` pairs, in place, on the stream's device (kernel F on a
        card).  Factors are computed BEFORE the pop (failure-atomic)."""
        op = self._pending[sid][0][1]
        tok = self._pending[sid][0][-1]
        st = self._streams[sid]
        dt = _dtype_of(op.vals)
        self._record_warm("sketch_sparse", op.nnz, st.m, st.n, op.rank, dt)
        u, s, v = _planner.op_low_rank_factors(op, st.m, st.n, self.policy, device=st.device,
                                               dtype=dt)
        self._pending[sid].popleft()
        # the op's token rides the LAST expanded pair
        self._pending[sid].extendleft(
            ("pair", u[:, i] * s[i], v[:, i], tok if i == op.rank - 1 else None)
            for i in range(op.rank - 1, -1, -1))
        self.stats.enqueued += op.rank - 1
        self.stats.ops_applied += 1

    def _maybe_autoflush(self) -> None:
        ready = sum(1 for q in self._pending.values() if q)
        if ready >= self.max_batch:
            self._flush_round()

    def flush(self) -> int:
        """Dispatch ALL pending events (possibly several rounds); returns the
        number applied.  Rounds run asynchronously: ``drain()`` waits."""
        with self._lock:
            applied = 0
            while any(self._pending.values()):
                applied += self._flush_round()
            return applied

    def drain(self) -> int:
        """Flush everything, then wait until all dispatched work is done."""
        with self._lock:
            applied = self.flush()
            self._barrier()
            return applied

    # -- in-flight buffer management ----------------------------------------

    def _reap_ready(self) -> None:
        """Retire finished rounds without blocking (oldest first)."""
        while self._in_flight and _is_ready(self._in_flight[0][0]):
            self._visible.extend(self._in_flight.popleft()[1])

    def _retire_oldest(self) -> None:
        event, tokens = self._in_flight.popleft()
        with _obs.span("reap", outputs=len(tokens)):
            if event is not None:
                event.synchronize()
        self._visible.extend(tokens)

    # -- observability --------------------------------------------------------

    def _publish_stats(self) -> None:
        """Mirror the stats into the metrics registry (``serve_*`` gauges)."""
        reg = _obs.registry()
        cache_key = (reg, reg.generation)
        if self._stat_gauges is None or self._stat_gauges[0] != cache_key:
            self._stat_gauges = (cache_key, [
                (f.name, reg.gauge(f"serve_{f.name}", **self._obs_labels))
                for f in dataclasses.fields(SvdServiceStats)])
        for name, gauge in self._stat_gauges[1]:
            gauge.set(getattr(self.stats, name))

    def _health_monitor(self) -> "_obs.HealthMonitor":
        if self._health is None:
            self._health = _obs.HealthMonitor(every=self.policy.health_every or 1,
                                              **self._obs_labels)
        return self._health

    def _barrier(self) -> None:
        """Wait for every dispatched round and every stream state: the only
        place (besides backpressure and snapshots) the service waits."""
        while self._in_flight:
            self._retire_oldest()
        for dev in {st.u.device for st in self._streams.values()}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def flush_round(self, *, max_depth: int = 1) -> int:
        """Dispatch ONE flush round.  ``max_depth > 1``: a stream whose head
        is a run of pairs contributes up to ``max_depth`` of them (power-of-two
        floored) as one rank-k column, through the engine's rank-k batch."""
        with self._lock:
            return self._flush_round(max_depth=max_depth)

    def has_capacity(self) -> bool:
        """True when a ``flush_round`` would dispatch WITHOUT waiting on an
        older round."""
        with self._lock:
            if self.max_in_flight == 0:
                return True
            self._reap_ready()
            return len(self._in_flight) < self.max_in_flight

    def _flush_round(self, *, max_depth: int = 1) -> int:
        """One round: pair-headed streams group by (geometry, depth) into
        batched engine calls, op-headed streams apply through the planner.
        One ``flush_round`` span; with obs enabled the stats mirror into the
        registry and the health monitor samples on its cadence."""
        live_ids = [sid for sid, q in self._pending.items() if q]
        if not live_ids:
            return 0
        with _obs.span("flush_round", streams=len(live_ids), max_depth=max_depth):
            applied = self._flush_round_impl(live_ids, max_depth)
        if _obs.enabled():
            self._publish_stats()
        return applied

    def _flush_round_impl(self, live_ids: list, max_depth: int) -> int:
        # backpressure: bound how far the host runs ahead of the device
        self._reap_ready()
        while self.max_in_flight > 0 and len(self._in_flight) >= self.max_in_flight:
            self._retire_oldest()
            self.stats.backpressure_waits += 1

        applied = 0
        ops_applied = 0
        round_tokens: list = []
        devices: set = set()

        round_ids = []
        for sid in live_ids:
            head = self._pending[sid][0]
            if head[0] == "op" and isinstance(head[1], _ops.Sparse):
                # the sketch's fixed test matrices make this expansion the
                # same bits before and after a snapshot/restore cycle
                self._expand_sparse_head(sid)
                head = self._pending[sid][0]
            if head[0] == "op":
                self._streams[sid] = self._apply_event(self._streams[sid], head)
                ev = self._pending[sid].popleft()
                if ev[-1] is not None:
                    round_tokens.append(ev[-1])
                devices.add(self._streams[sid].device)
                ops_applied += 1
            else:
                round_ids.append(sid)

        depths = {}
        for sid in round_ids:
            if max_depth > 1:
                run = 0
                for ev in self._pending[sid]:
                    if ev[0] != "pair":
                        break
                    run += 1
                    if run >= max_depth:
                        break
                depths[sid] = _depth_bucket(run, max_depth)
            else:
                depths[sid] = 1

        # health sampling: decided once a round; the first depth-1 group's
        # (pre-state, pair, post-state) feeds one probe after the dispatch
        sample_due = (_obs.enabled() and self.policy.health_every is not None
                      and self._health_monitor().due())
        probe_args = None

        keys = [truncated_geometry(self._streams[sid]) + (self._streams[sid].device, depths[sid])
                for sid in round_ids]

        for (m, n, r, dt, device, k), idxs in group_indices(keys).items():
            sids = [round_ids[i] for i in idxs]
            # peek, don't pop: a raising engine call leaves the pairs queued
            pairs = [[(q[j][1], q[j][2]) for j in range(k)]
                     for q in (self._pending[sid] for sid in sids)]
            states = [self._streams[sid] for sid in sids]
            bsz = len(sids)
            pad = 0
            if self.pad_to_bucket:
                pad = max(0, _bucket(bsz, self.max_batch) - bsz)

            t_stack = stack_trees([TruncatedSvd(s.u, s.s, s.v) for s in states])
            if k == 1:
                a_stack = _stack_to([col[0][0] for col in pairs], dt, device)
                b_stack = _stack_to([col[0][1] for col in pairs], dt, device)
                pad_a, pad_b = (pad, m), (pad, n)
            else:
                a_stack = _stack_to([[a for a, _ in col] for col in pairs], dt, device)
                b_stack = _stack_to([[b for _, b in col] for col in pairs], dt, device)
                pad_a, pad_b = (pad, k, m), (pad, k, n)
            if pad:
                # no-op pairs (a = b = 0) on the BATCH axis only, the last
                # state repeated; their outputs are discarded
                t_stack = TruncatedSvd(*(torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
                                         for x in t_stack))
                a_stack = torch.cat([a_stack, a_stack.new_zeros(pad_a)])
                b_stack = torch.cat([b_stack, b_stack.new_zeros(pad_b)])

            eng = self._engine_for(r)
            kind = "trunc_batch" if k == 1 else f"trunc_scan{k}"
            self._record_warm(kind, bsz + pad, m, n, r, dt)
            placement = dict(mesh=self.policy.mesh, batch_axis=self.policy.batch_axis)
            with _obs.span("dispatch", m=m, n=n, rank=r, batch=bsz + pad, depth=k):
                if k == 1:
                    out = eng.update_truncated_batch(t_stack, a_stack, b_stack, **placement)
                else:
                    out = eng.update_truncated_rank_k_batch(t_stack, a_stack, b_stack,
                                                            **placement)
                    self.stats.scan_rounds += 1
                    self.stats.max_depth = max(self.stats.max_depth, k)
            if sample_due and probe_args is None and k == 1:
                st1 = unstack_tree(out, 0)
                probe_args = (states[0].u, states[0].s, states[0].v,
                              a_stack[0], b_stack[0], st1.u, st1.s, st1.v)
            for j, sid in enumerate(sids):
                t = unstack_tree(out, j)
                self._streams[sid] = SvdState(u=t.u, s=t.s, v=t.v)
                for _ in range(k):
                    ev = self._pending[sid].popleft()
                    if ev[-1] is not None:
                        round_tokens.append(ev[-1])
            devices.add(device)
            applied += bsz * k
            self.stats.rounds += 1
            self.stats.max_batch = max(self.stats.max_batch, bsz + pad)

        # the round's completion: one event on the current stream (work on
        # one device; a round spread over several waits on each in turn)
        event = None
        cuda_devs = [d for d in devices if d.type == "cuda"]
        if cuda_devs:
            for d in cuda_devs[:-1]:
                torch.cuda.synchronize(d)
            with torch.cuda.device(cuda_devs[-1]):
                event = torch.cuda.Event()
                event.record()
        if self.max_in_flight == 0:
            if event is not None:
                event.synchronize()              # synchronous mode
            self._visible.extend(round_tokens)
        else:
            self._in_flight.append((event, round_tokens))
            self.stats.in_flight_peak = max(self.stats.in_flight_peak, len(self._in_flight))
        self.stats.flushes += 1
        self.stats.applied += applied
        if probe_args is not None:
            # a separate probe over the just-flushed factors, after the
            # round's launches; it reads its gauges to the host
            self._health_monitor().sample_update(*probe_args,
                                                 deflate_rtol=self.policy.deflate_rtol)
        return applied + ops_applied

    # -- checkpointing ------------------------------------------------------

    def snapshot(self) -> ServiceSnapshot:
        """Capture the whole service (a barrier: in-flight rounds retire
        first, so the states hold every flushed event and the FIFOs exactly
        the unflushed ones).  Pending pairs are copied to the host."""
        with self._lock:
            self._barrier()
            states, pend_a, pend_b, pend_ops, orders = [], [], [], [], []
            for sid, st in self._streams.items():
                states.append(st)
                a_vecs, b_vecs, stream_ops, order = [], [], [], []
                geom_m, geom_n = st.m, st.n
                geom_changed = False
                for ev in self._pending[sid]:
                    if ev[0] == "pair" and not geom_changed:
                        a_vecs.append(_host(ev[1]))
                        b_vecs.append(_host(ev[2]))
                        order.append("p")
                    elif ev[0] == "pair":
                        # a queued append changed the geometry: later pairs
                        # ride as k=1 RankK op leaves (restore unwraps them)
                        stream_ops.append(_ops.RankK(_host(ev[1])[:, None],
                                                     _host(ev[2])[:, None]))
                        order.append("o")
                    else:
                        stream_ops.append(ev[1])
                        order.append("o")
                        if ev[1].out_shape(geom_m, geom_n) != (geom_m, geom_n):
                            geom_changed = True
                if a_vecs:
                    pend_a.append(np.stack(a_vecs))
                    pend_b.append(np.stack(b_vecs))
                else:
                    pend_a.append(np.zeros((0, geom_m), _np_dtype(st.u.dtype)))
                    pend_b.append(np.zeros((0, geom_n), _np_dtype(st.v.dtype)))
                pend_ops.append(tuple(stream_ops))
                orders.append("".join(order))
            return ServiceSnapshot(
                states=tuple(states),
                pending_a=tuple(pend_a),
                pending_b=tuple(pend_b),
                pending_ops=tuple(pend_ops),
                version=SNAPSHOT_VERSION,
                stream_ids=tuple(self._streams),
                policy_spec=tuple(_policy_spec(self.policy).items()),
                max_batch=self.max_batch,
                pad_to_bucket=self.pad_to_bucket,
                max_in_flight=self.max_in_flight,
                stats=tuple(dataclasses.asdict(self.stats).items()),
                pending_order=tuple(orders),
                warmed=tuple(sorted(self._warmed)),
                obs_metrics=(_obs.registry().snapshot() if _obs.enabled() else ()),
            )

    def save(self, ckpt_dir, step: int, *, keep: int = 3):
        """``snapshot()`` + atomic write through ``train.checkpoint``."""
        return self.snapshot().save(ckpt_dir, step, keep=keep)

    @classmethod
    def from_snapshot(
        cls,
        snap: ServiceSnapshot,
        *,
        mesh=None,
        engine: SvdEngine | None = None,
        policy: UpdatePolicy | None = None,
        device="cuda",
    ) -> "SvdService":
        """Rebuild a service from a snapshot, its states on ``device``, and
        warm every entry of its warmed set there before returning (skipped
        under an explicit ``engine``, whose caches the caller manages).
        ``policy`` (a full override) or ``mesh`` (grafted onto the recorded
        policy spec) re-establish placement on the restoring topology."""
        dev = resolve_device(device)
        spec = dict(snap.policy_spec)
        if policy is None:
            if spec.get("had_mesh") and mesh is None:
                warnings.warn("snapshot was taken under a mesh-sharded policy but restore "
                              "got no mesh= (and no policy=): flushes run unsharded",
                              stacklevel=2)
            policy = _policy_from_spec(spec, mesh=mesh)
        svc = cls(engine=engine, max_batch=snap.max_batch, pad_to_bucket=snap.pad_to_bucket,
                  max_in_flight=snap.max_in_flight, policy=policy)
        n_streams = len(snap.stream_ids)
        pend_ops = snap.pending_ops or ((),) * n_streams
        orders = snap.pending_order or (None,) * n_streams
        for sid, st, pa, pb, sops, order in zip(snap.stream_ids, snap.states, snap.pending_a,
                                                snap.pending_b, pend_ops, orders):
            svc._streams[sid] = _state_to(st, dev)
            n_pairs = np.asarray(pa).shape[0] if not isinstance(pa, torch.Tensor) else pa.shape[0]
            if order is None:
                order = "p" * n_pairs          # v1 snapshots: all-pair FIFOs
            queue: deque = deque()
            pi = oi = 0
            for marker in order:
                if marker == "p":
                    queue.append(("pair", pa[pi], pb[pi], svc._new_token()))
                    pi += 1
                    continue
                op = sops[oi]
                oi += 1
                if isinstance(op, _ops.RankK):
                    # k=1 RankK leaves are pairs wrapped past a geometry change
                    for i in range(op.k):
                        queue.append(("pair", op.u[:, i], op.v[:, i], svc._new_token()))
                else:
                    queue.append(("op", op, svc._new_token()))
            svc._pending[sid] = queue
            m_eff, n_eff = svc._streams[sid].m, svc._streams[sid].n
            for ev in queue:
                if ev[0] == "op":
                    m_eff, n_eff = ev[1].out_shape(m_eff, n_eff)
            svc._eff_shape[sid] = (m_eff, n_eff)
        svc.stats = SvdServiceStats(**dict(snap.stats))
        if snap.obs_metrics:
            _obs.registry().restore(snap.obs_metrics)
        svc._warmed = {tuple(w) for w in snap.warmed}
        # cold-start control: ready every (kind, geometry) the snapshotted
        # service had run, so the first flush after restore builds nothing;
        # an explicit engine's caches are the caller's to manage
        if engine is None:
            svc.warm(device=dev)
        return svc

    def warm(self, device="cuda") -> None:
        """Ready every ``(kind, geometry)`` of the warmed set on ``device``:
        ``api.warmup`` for the update kinds (the engine's geometry cache and
        the route's kernel libraries), ``updates.warmup_sketch`` for the
        sketch kinds.  ``restore`` calls it before it returns."""
        for kind, batch, m, n, r, dtype_name in sorted(self._warmed):
            dt = as_torch_dtype(dtype_name)
            if kind in ("sketch_dense", "sketch_sparse"):
                # the batch slot carries nnz for the sparse kind
                _sketch.warmup_sketch(
                    m=m, n=n, k=r, oversample=self.policy.sketch_oversample,
                    power_iters=self.policy.sketch_power_iters,
                    nnz=batch if kind == "sketch_sparse" else None, dtype=dt, device=device)
                continue
            # depth-batched rounds record "trunc_scan<k>"
            scan_k = int(kind[len("trunc_scan"):]) if kind.startswith("trunc_scan") else None
            _api_warmup(self.policy, m=m, n=n, batch=batch if kind != "trunc" else None,
                        rank=r, k=scan_k, dtype=dt, device=device)

    @classmethod
    def restore(
        cls,
        ckpt_dir,
        *,
        step: int | None = None,
        mesh=None,
        engine: SvdEngine | None = None,
        policy: UpdatePolicy | None = None,
        cache_dir=None,
        device="cuda",
    ) -> tuple[int, "SvdService"]:
        """Load the latest (or ``step``-th) snapshot and rebuild the service on
        ``device``; returns ``(step, service)``.  The restored service, fed
        the same later traffic, gives the same bits as one that never
        stopped.  ``cache_dir`` points the kernels' build cache there first
        (``api.enable_compilation_cache``)."""
        if cache_dir is not None:
            from repro_torch.api.cache import enable_compilation_cache

            enable_compilation_cache(cache_dir)
        step, snap = ServiceSnapshot.load(ckpt_dir, step)
        return step, cls.from_snapshot(snap, mesh=mesh, engine=engine, policy=policy,
                                       device=device)
