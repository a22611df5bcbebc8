"""TorchTrainer — the training entry point (port of
``ray_tpu/train/trainer.py``'s ``JaxTrainer``).

The same constructor and API: ``state``, ``restore``, ``shard_batch``
and ``fit(data, num_steps, report)``, with ``ScalingConfig``,
``TrainerConfig``, ``RunConfig`` and ``Result``.

The JAX trainer is one controller over a mesh of devices; the port runs
one process a device, each building its own ``TorchTrainer`` over the
default ``torch.distributed`` process group (``train/backend.py``:
``launch`` or ``torchrun``, then ``init_process_group``).
``ScalingConfig.mesh_spec`` lays the mesh over the group's ranks
(``parallel/mesh.py``); the data axes (dp, fsdp and their DCN pairs)
and ``ep`` may exceed 1, and the other axes raise, naming the ROADMAP
item that ports them.  Each rank initialises the same full params from
``init_params`` (a ``torch.Generator`` on its device, seeded with
``seed``), keeps its shards of them and of the optimizer state
(``params_axes`` and ``rules`` give the params' layout: the "expert"
axis puts E/ep experts, and their router columns, on each ``ep`` rank;
``zero_sharding`` the ZeRO layout of the state, sharded over the data
members inside each ``ep`` coordinate, ``train/zero.py``), and ``shard_batch`` gives it its rows of
each global batch (every ``ep`` rank of a data member the same rows).
Over a process group the step is the data-parallel one
(``train/step.py``) at any world size.  Over several data members the
loss splits as it declares (``parallel/loss_split.py``): by tokens (the
Llama and Mamba-2 losses), by rows (ViT) or as its share of the global
objective (Mixtral, CLIP); a loss that declares nothing and whose aux
is not a token split's is refused.  Without a process group the
trainer runs the single-device step on one device: the card unless
``ScalingConfig(devices=["cpu"])`` asks for the CPU.
``zero_sharding`` needs a process group (one of a single rank will do).

Telemetry as in the JAX trainer: the six ``raytpu_train_*`` families
and the ``train.step`` / ``train.data_wait`` / ``train.compute`` /
``train.checkpoint`` spans, and on report steps the device plane's
memory gauges (``util/xprof.sample_device_memory``, absent on the CPU);
``opt_state_bytes`` reads ``zero.opt_state_bytes`` of the rank's shards.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.mesh import Mesh, MeshSpec, create_mesh
from ray_tpu_torch.parallel.sharding import axis_tuple, spec_for
from ray_tpu_torch.train import zero
from ray_tpu_torch.train.backend import backend_for
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    default_optimizer,
)
from ray_tpu_torch.train.step import compile_train_step
from ray_tpu_torch.util import tracing, xprof

_TELEMETRY = None


def _telemetry():
    """Trainer metric singletons (re-registered on later fetches so a
    registry clear() cannot drop them)."""
    global _TELEMETRY
    from ray_tpu_torch.util import metrics

    if _TELEMETRY is None:
        _TELEMETRY = {
            "step_s": metrics.Histogram(
                "raytpu_train_step_seconds",
                "Host-side duration of one training step (dispatch, plus "
                "device sync on report steps).",
                boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                            5.0, 30.0, 120.0],
            ),
            "data_wait_s": metrics.Histogram(
                "raytpu_train_data_wait_seconds",
                "Seconds each step waited on the input iterator + batch "
                "copy to the device.",
                boundaries=[0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                            1.0, 5.0],
            ),
            "steps": metrics.Counter(
                "raytpu_train_steps_total",
                "Training steps completed.",
            ),
            "checkpoints": metrics.Counter(
                "raytpu_train_checkpoints_total",
                "Checkpoints written by the trainer.",
            ),
            "opt_bytes": metrics.Gauge(
                "raytpu_train_opt_state_bytes",
                "Optimizer-state footprint: scope=global across the "
                "devices, scope=per_device resident on one device (equal "
                "on one device).",
                tag_keys=("scope",),
            ),
            "hbm_headroom": metrics.Gauge(
                "raytpu_train_hbm_headroom_bytes",
                "Per-device memory left above the peak watermark "
                "(total_memory - max_memory_allocated), sampled on report "
                "steps; absent on the CPU.",
                tag_keys=("device",),
            ),
        }
    else:
        reg = metrics.registry()
        for m in _TELEMETRY.values():
            reg.register(m)
    return _TELEMETRY


# Mesh axes the data-parallel trainer refuses, with the ROADMAP item
# (queue 1) that ports each.
_MODEL_AXES = {
    "tp": "tensor parallelism (item 6 part 3)",
    "dcn_tp": "tensor parallelism across hosts (item 6 part 3)",
    "sp": "sequence parallelism, ops/ring_attention.py and ops/ulysses.py "
          "(item 7)",
    "pp": "pipeline parallelism, parallel/pipeline.py (item 7)",
    "dcn_pp": "pipeline parallelism across hosts (item 7)",
}


def _world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass
class ScalingConfig:
    """Parity: air.ScalingConfig → the mesh over the process group's
    ranks and this rank's device.  ``devices``: None (this rank's card,
    ``cuda:LOCAL_RANK`` as ``backend.init_process_group`` set it), one
    device for every rank (e.g. ``["cpu"]``), or one a rank."""

    mesh_spec: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    devices: Optional[list] = None

    def _check(self) -> Tuple[int, int]:
        spec = self.mesh_spec
        for axis, what in _MODEL_AXES.items():
            if getattr(spec, axis) > 1:
                raise NotImplementedError(
                    f"MeshSpec.{axis}={getattr(spec, axis)}: {what} is not "
                    "ported to ray_tpu_torch yet (ROADMAP.md queue 1, "
                    "multi-device); the trainer shards over the data axes "
                    "(dp, fsdp, dcn_dp, dcn_fsdp) and the experts over ep "
                    "only")
        world, rank = _world()
        if world == 1:
            try:
                spec.sizes(1)
            except ValueError as e:
                raise NotImplementedError(
                    f"ScalingConfig asks for more than one device ({spec}: "
                    f"{e}) but this process is not in a process group of "
                    "that size: start one process a device "
                    "(ray_tpu_torch.train.backend.launch, or torchrun) and "
                    "call backend.init_process_group in each") from None
            if self.devices is not None and len(self.devices) != 1:
                raise NotImplementedError(
                    f"ScalingConfig asks for more than one device "
                    f"({self.devices}) but this process is not in a process "
                    "group of that size: start one process a device "
                    "(ray_tpu_torch.train.backend.launch, or torchrun)")
        else:
            spec.sizes(world)
        return world, rank

    def device(self) -> torch.device:
        """This rank's device."""
        world, rank = self._check()
        if self.devices is None:
            return resolve_device(None)
        if len(self.devices) == 1:
            return resolve_device(self.devices[0])
        if len(self.devices) == world:
            return resolve_device(self.devices[rank])
        raise ValueError(f"ScalingConfig lists {len(self.devices)} devices "
                         f"for {world} ranks: give one, or one a rank")

    def mesh(self) -> Mesh:
        """The mesh of ``mesh_spec`` over the process group's ranks."""
        self._check()
        return create_mesh(self.mesh_spec)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Step-program options.

    ``zero_sharding`` shards the optimizer state (and the weight update)
    across the data axes, ZeRO-style — grads reduce-scatter, each rank
    updates its part, params all-gather back (train/zero.py); it needs a
    process group.  ``grad_accum`` splits each batch into that many
    microbatches before the single update (train/step.py)."""

    zero_sharding: bool = False
    grad_accum: int = 1


@dataclasses.dataclass
class RunConfig:
    """Parity: air.RunConfig (name, storage_path, checkpoint/report
    cadence)."""

    name: str = "run"
    storage_path: Optional[str] = None
    checkpoint_every: int = 0  # steps; 0 = only final
    checkpoints_to_keep: int = 3
    report_every: int = 10


@dataclasses.dataclass
class Result:
    """Parity: air.Result (metrics, checkpoint path, error)."""

    metrics: Dict[str, float]
    metrics_history: List[Dict[str, float]]
    checkpoint_path: Optional[str]
    error: Optional[BaseException] = None


class TorchTrainer:
    def __init__(
        self,
        *,
        init_params: Callable[[torch.Generator], Any],
        loss_fn: Callable[[Any, Dict[str, torch.Tensor]],
                          Tuple[torch.Tensor, Dict]],
        params_axes: Any = None,
        batch_axes: Optional[Dict[str, Tuple[Optional[str], ...]]] = None,
        optimizer=None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        trainer_config: Optional[TrainerConfig] = None,
        rules: Any = None,
        seed: int = 0,
    ):
        self.init_params_fn = init_params
        self.loss_fn = loss_fn
        self.params_axes = params_axes
        self.batch_axes = batch_axes
        self.tx = optimizer or default_optimizer()
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.trainer_config = trainer_config or TrainerConfig()
        self.rules = rules
        self.seed = seed
        self.device = self.scaling.device()
        self.mesh = self.scaling.mesh()
        self._state: Optional[TrainState] = None
        self._state_sh: Optional[TrainState] = None
        self._layout: Optional[zero.StepLayout] = None
        self._step_fn = None

    # -- setup -------------------------------------------------------------

    def _build(self):
        tc = self.trainer_config
        if tc.zero_sharding and not self.mesh.distributed:
            raise NotImplementedError(
                "zero_sharding shards the optimizer state over a "
                "torch.distributed process group, and none is initialised: "
                "call ray_tpu_torch.train.backend.init_process_group first "
                "(a group of one rank will do)")
        if self.mesh.distributed:
            import torch.distributed as dist

            want = backend_for(self.device)
            if dist.get_backend() != want:
                raise ValueError(
                    f"this rank trains on {self.device}, whose collectives "
                    f"need a {want} process group, but the default group "
                    f"is {dist.get_backend()}: form the group for this "
                    f"device (backend.init_process_group(device=...))")
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        state = create_train_state(self.init_params_fn(gen), self.tx)
        if self.mesh.distributed:
            self._state_sh = zero.state_shardings(
                self.mesh, state, self.params_axes, self.rules,
                zero=tc.zero_sharding)
            state = zero.shard_state(state, self._state_sh)
            self._layout = zero.StepLayout.build(
                self.mesh, state, self._state_sh, tc.zero_sharding,
                self.rules)
        self._state = state
        self._step_fn = compile_train_step(
            self.loss_fn, self.tx, zero_sharding=tc.zero_sharding,
            grad_accum=tc.grad_accum, layout=self._layout)
        self._emit_memory_gauges()

    def opt_state_bytes(self) -> Dict[str, int]:
        """``zero.opt_state_bytes`` of this rank's optimizer state."""
        return zero.opt_state_bytes(
            self.state.opt_state,
            self._state_sh.opt_state if self._state_sh else None)

    def _emit_memory_gauges(self):
        """The optimizer state's footprint, and on the card the memory
        left above the peak watermark (absent, not zero, on the CPU)."""
        tm = _telemetry()
        b = self.opt_state_bytes()
        tm["opt_bytes"].set(b["global"], tags={"scope": "global"})
        tm["opt_bytes"].set(b["per_device"], tags={"scope": "per_device"})
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            tm["hbm_headroom"].set(
                total - torch.cuda.max_memory_allocated(self.device),
                tags={"device": str(self.device)})

    @property
    def state(self) -> TrainState:
        if self._state is None:
            self._build()
        return self._state

    def _checkpoints(self, path: str, **kw) -> CheckpointManager:
        return CheckpointManager(
            path, mesh=self.mesh,
            shardings=self._state_sh if self._state_sh else None, **kw)

    def restore(self, path: str) -> int:
        """Resume from the latest checkpoint under ``path`` (each rank
        reads its shards); returns its step."""
        if self._state is None:
            self._build()
        mngr = self._checkpoints(path)
        self._state = mngr.restore(self._state)
        mngr.close()
        return int(self._state.step)

    # -- training ----------------------------------------------------------

    def _rows(self, key: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch array: the chunk of the
        leading dim that JAX's ``("batch", ...)`` sharding gives its
        device, taken from each of the ``grad_accum`` microbatches (the
        step splits its rows into microbatches of consecutive rows, as
        the JAX step splits the global batch)."""
        mesh = self.mesh
        logical = (self.batch_axes or {}).get(
            key, ("batch",) + (None,) * (x.dim() - 1))
        spec = spec_for(logical, self.rules,
                        mesh_axes=frozenset(mesh.axis_names))
        entries = list(spec) + [None] * (x.dim() - len(spec))
        for e in entries[1:]:
            if any(mesh.shape[a] > 1 for a in axis_tuple(e)):
                raise NotImplementedError(
                    f"batch {key!r}: only its leading dim may be split "
                    f"({spec})")
        axes = axis_tuple(entries[0])
        n = 1
        idx = 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.coords[a]
        if n == 1:
            return x
        k = self.trainer_config.grad_accum
        if x.shape[0] % (n * k):
            raise ValueError(
                f"batch {key!r}: {x.shape[0]} rows do not split into "
                f"{k} microbatches over {n} ranks")
        parts = x.reshape(k, n, x.shape[0] // (n * k), *x.shape[1:])
        return parts[:, idx].reshape(-1, *x.shape[1:])

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global host batch, as tensors on its
        device (the whole batch on one rank)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
            if self.mesh.size > 1:
                t = self._rows(k, t)
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def fit(
        self,
        data: Iterable[Dict[str, np.ndarray]],
        *,
        num_steps: int,
        report: Optional[Callable[[Dict[str, float]], None]] = None,
    ) -> Result:
        if self._state is None:
            self._build()
        rc = self.run_config
        ckpt = None
        if rc.storage_path:
            ckpt = self._checkpoints(f"{rc.storage_path}/{rc.name}",
                                     max_to_keep=rc.checkpoints_to_keep)
        history: List[Dict[str, float]] = []
        last_metrics: Dict[str, float] = {}
        tm = _telemetry()
        it = iter(data)
        t0 = time.perf_counter()
        error: Optional[BaseException] = None
        try:
            for i in range(num_steps):
                step = i + 1
                with tracing.span("train.step", attributes={"step": step}):
                    w0 = time.perf_counter()
                    with tracing.span("train.data_wait"):
                        batch = self.shard_batch(next(it))
                    c0 = time.perf_counter()
                    tm["data_wait_s"].observe(c0 - w0)
                    # Host-side timing: the card runs asynchronously, so
                    # off-report steps measure the enqueue; report steps
                    # wait below.
                    with tracing.span("train.compute"):
                        self._state, metrics = self._step_fn(self._state,
                                                             batch)
                    tm["step_s"].observe(time.perf_counter() - c0)
                    tm["steps"].inc()
                    if step % rc.report_every == 0 or step == num_steps:
                        # float() of a device value waits for the step.
                        m = {k: float(v) for k, v in metrics.items()}
                        m["steps_per_sec"] = step / (time.perf_counter()
                                                     - t0)
                        history.append(m)
                        last_metrics = m
                        # The shared device-memory gauges (absent on the
                        # CPU), then the trainer's own.
                        xprof.sample_device_memory()
                        self._emit_memory_gauges()
                        if report:
                            report(m)
                    if ckpt and rc.checkpoint_every \
                            and step % rc.checkpoint_every == 0:
                        with tracing.span("train.checkpoint",
                                          attributes={"step": step}):
                            ckpt.save(step, self._state)
                        tm["checkpoints"].inc()
        except BaseException as e:  # report partial progress + the failure
            error = e
            if not isinstance(e, Exception):
                raise
        finally:
            path = None
            if ckpt:
                final_step = int(self._state.step)
                if error is None and ckpt.latest_step() != final_step:
                    ckpt.save(final_step, self._state, wait=True)
                path = f"{rc.storage_path}/{rc.name}"
                ckpt.close()
        return Result(metrics=last_metrics, metrics_history=history,
                      checkpoint_path=path, error=error)
