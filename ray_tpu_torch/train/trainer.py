"""TorchTrainer — the training entry point (port of
``ray_tpu/train/trainer.py``'s ``JaxTrainer``).

The same constructor and API: ``state``, ``restore``, ``shard_batch``
(here a copy of the host batch to the device) and ``fit(data,
num_steps, report)``, with ``ScalingConfig``, ``TrainerConfig``,
``RunConfig`` and ``Result``.  The port trains on one device: the
card unless ``ScalingConfig(devices=["cpu"])`` asks for the CPU, and a
mesh or device list that asks for more raises NotImplementedError.
``params_axes``, ``batch_axes`` and ``rules`` are accepted so calls
cross unchanged and are unused on one device.  ``init_params`` receives
a ``torch.Generator`` on the trainer's device, seeded with ``seed``.
Telemetry as in the JAX trainer: the six ``raytpu_train_*`` families
and the ``train.step`` / ``train.data_wait`` / ``train.compute`` /
``train.checkpoint`` spans, and on report steps the device plane's
memory gauges (``util/xprof.sample_device_memory``, absent on the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
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


def opt_state_bytes(opt_state: Any) -> Dict[str, int]:
    """Optimizer-state bytes: ``global`` and ``per_device``, equal on one
    device (the JAX package's ``zero.opt_state_bytes``).  Tensor leaves
    only: the step count is a host int here."""
    def walk(node) -> int:
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, (tuple, list)):
            return sum(walk(v) for v in node)
        if torch.is_tensor(node):
            return node.numel() * node.element_size()
        return 0

    n = walk(opt_state)
    return {"global": n, "per_device": n}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The JAX package's mesh layout (``ray_tpu/parallel/mesh.py``), kept
    for its fields: on one device every axis must resolve to 1 (-1
    absorbs the remaining devices, so it is 1 here)."""

    pp: int = 1
    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    dcn_pp: int = 1
    dcn_dp: int = 1
    dcn_fsdp: int = 1
    dcn_tp: int = 1


@dataclasses.dataclass
class ScalingConfig:
    """Parity: air.ScalingConfig → one device.  ``devices``: None (the
    card) or one device, e.g. ``["cpu"]``."""

    mesh_spec: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    devices: Optional[list] = None

    def device(self) -> torch.device:
        big = {f.name: getattr(self.mesh_spec, f.name)
               for f in dataclasses.fields(self.mesh_spec)
               if getattr(self.mesh_spec, f.name) > 1}
        if big or (self.devices is not None and len(self.devices) != 1):
            raise NotImplementedError(
                f"ScalingConfig asks for more than one device (mesh axes "
                f"{big}, devices {self.devices}): multi-device training "
                "(expert parallelism over ep included) is not ported to "
                "ray_tpu_torch yet (ROADMAP.md queue 1 item 6, "
                "multi-device)")
        return resolve_device(self.devices[0] if self.devices else None)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Step-program options.  ``grad_accum`` splits each batch into that
    many microbatches before the single update; ``zero_sharding`` needs
    several devices and raises NotImplementedError."""

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
        self._state: Optional[TrainState] = None
        self._step_fn = None

    # -- setup -------------------------------------------------------------

    def _build(self):
        self._step_fn = compile_train_step(
            self.loss_fn, self.tx,
            zero_sharding=self.trainer_config.zero_sharding,
            grad_accum=self.trainer_config.grad_accum)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._state = create_train_state(self.init_params_fn(gen), self.tx)
        self._emit_memory_gauges()

    def _emit_memory_gauges(self):
        """The optimizer state's footprint, and on the card the memory
        left above the peak watermark (absent, not zero, on the CPU)."""
        tm = _telemetry()
        b = opt_state_bytes(self._state.opt_state)
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

    def restore(self, path: str) -> int:
        """Resume from the latest checkpoint under ``path``; returns its
        step."""
        if self._state is None:
            self._build()
        mngr = CheckpointManager(path)
        self._state = mngr.restore(self._state)
        mngr.close()
        return int(self._state.step)

    # -- training ----------------------------------------------------------

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The host batch as tensors on the trainer's device."""
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

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
            ckpt = CheckpointManager(f"{rc.storage_path}/{rc.name}",
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
