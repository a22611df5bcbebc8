"""Training backends: wiring a ``torch.distributed`` world (port of
``ray_tpu/train/backend.py``).

The JAX package calls ``jax.distributed.initialize`` in every worker, so
that one SPMD program spans every device.  The port runs one process a
device, joined by the default process group: ``init_process_group``
picks NCCL when the rank's device is a card and gloo when it is the
CPU, binds the rank to ``cuda:local_rank``, and takes an explicit
timeout, so a rank that dies leaves the others with an error instead of
a hang.  Nothing falls back: an NCCL group that fails to form raises.

``launch(fn, world_size, devices)`` starts one process a rank on this
machine (``spawn``), forms the group in each, runs ``fn`` and returns
every rank's result; ``torchrun`` does the same from the command line
(its ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
``MASTER_PORT`` are read by ``init_process_group`` when no address is
given).  ``TorchDistributedBackend.on_start`` would form the group
across the core runtime's worker group, which the port does not have
yet (ROADMAP.md queue 1 item 6 part 5).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass
class TorchBackendConfig:
    """Parity: BackendConfig.  ``timeout_s`` bounds the group's
    rendezvous and every collective on it; the backend follows the
    rank's device (``backend_for``)."""

    # 0 = pick a free port on this host.
    coordinator_port: int = 0
    timeout_s: float = 300.0


def _pick_coordinator(port: int) -> str:
    """``host:port`` of a free port on this machine (the loopback
    address: ``launch`` starts every rank here)."""
    host = "127.0.0.1"
    if port == 0:
        with socket.socket() as s:
            s.bind((host, 0))
            port = s.getsockname()[1]
    return f"{host}:{port}"


def backend_for(device: torch.device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def init_process_group(rank: Optional[int] = None,
                       world_size: Optional[int] = None, *,
                       device: DeviceLike = None,
                       init_method: Optional[str] = None,
                       config: Optional[TorchBackendConfig] = None
                       ) -> torch.device:
    """Join (or, at world size 1, form) the default process group and
    return this rank's device.

    ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE`` (torchrun),
    else 0 and 1.  ``device`` None is ``cuda:LOCAL_RANK`` (the card of
    this rank; raises when none is visible), ``"cpu"`` only on request.
    ``init_method`` defaults to ``env://`` when ``MASTER_ADDR`` is set,
    and to a free loopback port at world size 1."""
    import torch.distributed as dist

    cfg = config or TorchBackendConfig()
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(device)
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = "tcp://" + _pick_coordinator(cfg.coordinator_port)
        else:
            raise ValueError("init_process_group: a world of several ranks "
                             "needs init_method (tcp://host:port) or "
                             "MASTER_ADDR/MASTER_PORT")
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend=backend_for(dev), init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=cfg.timeout_s), **kwargs)
    return dev


def shutdown() -> None:
    """Leave the default process group (a no-op when none is formed)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _run_rank(rank: int, world_size: int, device: str, addr: str,
              cfg: TorchBackendConfig, work, results) -> None:
    """One rank of ``launch``: form the group, take ``(fn, args)`` from
    ``work``, run it, report."""
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                          LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world_size))
        if device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // world_size))
        fn, args = work.get()
        init_process_group(rank, world_size, device=device,
                           init_method=f"tcp://{addr}", config=cfg)
        out = fn(*args)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        shutdown()


def launch(fn: Callable, world_size: int,
           devices: Optional[Sequence[DeviceLike]] = None, *,
           args: tuple = (), timeout_s: float = 600.0,
           config: Optional[TorchBackendConfig] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks of a new process group
    on this machine, one spawned process each, and return their results
    in rank order.  ``devices``: None gives rank r ``cuda:r``; one device
    (e.g. ``["cpu"]``) serves every rank; else one a rank.  ``fn`` and
    ``args`` are pickled (a module-level function).  Every rank is
    killed when ``timeout_s`` passes or any rank fails; then this
    raises, with the failing ranks' tracebacks."""
    import multiprocessing as mp

    cfg = config or TorchBackendConfig()
    if devices is None:
        devs = [f"cuda:{r}" for r in range(world_size)]
    elif len(devices) == 1:
        devs = [str(devices[0])] * world_size
    elif len(devices) == world_size:
        devs = [str(d) for d in devices]
    else:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks: "
                         "give one device, or one a rank")
    ctx = mp.get_context("spawn")
    work, results = ctx.Queue(), ctx.Queue()
    addr = _pick_coordinator(cfg.coordinator_port)
    procs = [ctx.Process(target=_run_rank, daemon=True,
                         args=(r, world_size, devs[r], addr, cfg, work,
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    # The work goes through a queue, not the processes' arguments: a
    # child reads its arguments before the next child starts, so large
    # ones would start the ranks one after the other.
    for _ in procs:
        work.put((fn, args))
    deadline = time.monotonic() + timeout_s
    got, errors = {}, {}
    try:
        while len(got) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                silent = sorted(set(range(world_size)) - set(got)
                                - set(errors))
                raise TimeoutError(f"launch: ranks {silent} gave no result "
                                   f"within {timeout_s} s")
            try:
                rank, status, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                if errors or any(p.exitcode not in (None, 0)
                                 for p in procs):
                    # A rank failed or died: the others may wait on it
                    # in a collective until their timeout.  Stop now.
                    if not errors:
                        errors = {i: f"exit code {p.exitcode}"
                                  for i, p in enumerate(procs)
                                  if p.exitcode not in (None, 0)}
                    break
                continue
            (got if status == "ok" else errors)[rank] = out
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("launch: " + "\n".join(
            f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [got[r] for r in range(world_size)]


class TorchDistributedBackend:
    """Forms the world across the core runtime's worker group (parity:
    Backend — on_start builds the process group, on_shutdown destroys
    it).  The port has no worker group yet."""

    def __init__(self, config: Optional[TorchBackendConfig] = None):
        self.config = config or TorchBackendConfig()
        self.coordinator_address: Optional[str] = None

    def on_start(self, worker_group) -> List[int]:
        raise NotImplementedError(
            "TorchDistributedBackend.on_start needs the core runtime's "
            "worker group, which is not ported to ray_tpu_torch yet "
            "(ROADMAP.md queue 1 item 6 part 5); start ranks with "
            "train.backend.launch or torchrun")

    def on_shutdown(self, worker_group) -> None:
        raise NotImplementedError(
            "TorchDistributedBackend.on_shutdown: see on_start "
            "(ROADMAP.md queue 1 item 6 part 5)")
