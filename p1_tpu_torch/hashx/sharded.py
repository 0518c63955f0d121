"""Sharded nonce search: one search step over a mesh of slots, min-reduced.

The port of ``p1_tpu/hashx/sharded.py`` (``shard_map`` + ``lax.pmin`` over
a ``jax.sharding.Mesh``), registered as ``sharded`` in the port's registry.
The mesh is a 1-D list of *slots*.  Slot d of a step over
``[base, base + n·batch)`` scans the contiguous block
``[base + d·batch, base + (d+1)·batch)`` with the single-card step, maps a
hit to the global offset ``d·batch + off`` and a miss to the whole span,
and the step's result is the min over slots: the earliest nonce of the
whole range, bit-identical to one scan of it.

- **Real slots**: one per device, ``make_mesh(n_devices)`` over the first
  ``n_devices`` cards (or the CPU, which is one device).
- **Virtual slots**: ``make_mesh(n, device, slots_per_device=k)`` puts k
  slots on each device, each with its own CUDA stream: the counterpart of
  the JAX package's ``--xla_force_host_platform_device_count`` CPU mesh,
  which the CPU tests (8 slots on the CPU) and the card's smoke run
  (4 slots on one card) use.  It is only built when asked for.
- **Across processes**: after ``parallel.init_distributed`` the mesh is
  global, as ``jax.devices()`` is after ``jax.distributed.initialize``:
  ``n_devices`` counts every process's slots, process r holds slots
  ``r·L .. r·L + L − 1``, and the min runs over every process too.  That
  last min is one gloo ``all_reduce`` of the step's 8-byte local result,
  at the point where the pipelined host loop reads it back anyway
  (``ShardedBackend._global_offset``), so every process sees the same
  offset at the same drain point of every step.

Each slot's body is the ``cuda`` backend's step (``cuda_search_fn``: the
``sha256d_search.cu`` kernel on a CUDA slot, its plain version on a CPU
one) on the slot's stream, or with ``kernel="plain"`` the plain version
(``plain_search_step``) on every slot.  The cross-slot min is ``torch.min`` over the
slots' cells, in int64: the global offset and the span reach 2³² − 1, which
the JAX package carries in uint32 and torch cannot.
"""

from __future__ import annotations

import contextlib

import torch

from p1_tpu_torch.hashx.backend import HashBackend, register
from p1_tpu_torch.hashx.cuda_backend import (
    _CPU_BATCH,
    _DEFAULT_BATCH,
    _DEFAULT_SUB,
    _DEFAULT_THREADS,
    _check_tile,
    cuda_search_fn,
    plain_search_step,
)
from p1_tpu_torch.hashx.torch_backend import PipelinedSearchMixin, SearchArrays, StepFn
from p1_tpu_torch.hashx.torch_sha256 import MASK32

#: The per-slot bodies: the search kernel's step, or the plain version.
KERNELS = ("cuda", "plain")


class Mesh:
    """A 1-D mesh of search slots.

    ``devices[i]`` and ``streams[i]`` are local slot i's device and its
    CUDA stream (None on the CPU).  Local slot i is global slot
    ``first + i`` of ``size``; ``group`` is the process group the min runs
    over when the mesh spans processes, else None."""

    def __init__(self, devices, streams, first: int = 0, size: int | None = None, group=None):
        self.devices = tuple(devices)
        self.streams = tuple(streams)
        self.first = first
        self.size = len(self.devices) if size is None else size
        self.group = group

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def stream(self, i: int):
        """Context that makes local slot i's stream current (no-op on the CPU)."""
        s = self.streams[i]
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)


def _physical_devices(device) -> list[torch.device]:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a cuda mesh needs a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch version"
            )
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"a mesh runs on cuda or cpu, not {device!r}")


def _process_group():
    """(world size, rank, group) of the process group the pod formed, or
    (1, 0, None) in a process of its own."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


def make_mesh(
    n_devices: int | None = None,
    device: str | torch.device = "cuda",
    slots_per_device: int = 1,
    across_processes: bool = True,
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` slots (default: all).

    ``device`` is ``cuda`` (every card, raising without one), ``cuda:i``
    (that card) or ``cpu``; ``slots_per_device`` > 1 makes a virtual mesh.
    With a process group up (``parallel.init_distributed``) and
    ``across_processes``, slots count across every process, each holding
    an equal share; ``across_processes=False`` keeps the mesh local."""
    if slots_per_device < 1:
        raise ValueError(f"slots_per_device must be >= 1, got {slots_per_device}")
    local = [d for d in _physical_devices(device) for _ in range(slots_per_device)]
    world, rank, group = _process_group() if across_processes else (1, 0, None)
    available = world * len(local)
    if n_devices is not None:
        if n_devices > available:
            raise ValueError(f"requested {n_devices} devices, only {available} available")
        if n_devices < 1 or n_devices % world:
            raise ValueError(f"{n_devices} devices do not split over {world} processes")
        local = local[: n_devices // world]
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in local]
    return Mesh(local, streams, first=rank * len(local), size=world * len(local),
                group=group if world > 1 else None)  # fmt: skip


def _on(arrays: SearchArrays, device: torch.device) -> SearchArrays:
    if arrays.device == device:
        return arrays
    return SearchArrays(arrays.words, *(t.to(device) for t in (arrays.midstate, arrays.tail, arrays.target)))


def jit_sharded_step(
    mesh: Mesh,
    batch_per_device: int,
    kernel: str = "cuda",
    sub: int = _DEFAULT_SUB,
    threads: int = _DEFAULT_THREADS,
) -> StepFn:
    """The sharded step over ``mesh``'s local slots (the counterpart of
    the JAX package's jitted ``shard_map`` step).

    (SearchArrays, nonce_base) -> (1,) int64 tensor on the first local
    slot's device: the offset of the earliest hit in
    ``[nonce_base, nonce_base + size·batch)`` among the local slots, or
    the span.  Across processes, ``ShardedBackend`` takes the min of the
    processes' results when it reads one back.  Each call builds a new
    step: ``ShardedBackend`` keeps the one it uses."""
    span = mesh.size * batch_per_device
    if span >= 1 << 32:
        raise ValueError("step span must stay below uint32 nonce space")
    if kernel == "cuda":
        body = cuda_search_fn(batch_per_device, sub, threads)
    elif kernel == "plain":

        def body(arrays: SearchArrays, base: int, device: torch.device) -> torch.Tensor:
            return plain_search_step(_on(arrays, device), base, batch_per_device)

    else:
        raise ValueError(f"unknown sharded kernel {kernel!r}")
    home = mesh.devices[0]
    slot_offsets = torch.tensor(
        [(mesh.first + i) * batch_per_device for i in range(len(mesh.devices))],
        dtype=torch.int64, device=home,
    )  # fmt: skip

    def step(arrays: SearchArrays, nonce_base: int) -> torch.Tensor:
        cells = []
        if home.type == "cuda":
            # Each slot's stream starts after what the caller's stream
            # has queued (the arrays, the previous step's read-back).
            ready = torch.cuda.current_stream(home)
            for s in mesh.streams:
                s.wait_stream(ready)
        for i, device in enumerate(mesh.devices):
            base = (nonce_base + (mesh.first + i) * batch_per_device) & MASK32
            with mesh.stream(i):
                # The cell is allocated, filled and lowered on this stream.
                cells.append(body(arrays, base, device))
        if home.type == "cuda":
            current = torch.cuda.current_stream(home)
            for s, cell in zip(mesh.streams, cells):
                current.wait_stream(s)
                cell.record_stream(current)
        offsets = torch.cat([c.to(home) for c in cells]).to(torch.int64)
        hit = offsets < batch_per_device
        global_off = torch.where(hit, slot_offsets + offsets, torch.full_like(offsets, span))
        return global_off.min().reshape(1)

    return step


@register("sharded")
class ShardedBackend(PipelinedSearchMixin, HashBackend):
    """SHA-256d search sharded over every slot of a mesh (``sharded``).

    ``batch`` is the per-slot batch; one step evaluates ``n_devices ·
    batch`` nonces.  With one slot this is the ``cuda`` backend's search
    step for step (the min is a no-op), so the same backend name works
    from the CPU to a pod.  ``device="cuda"`` (the default) raises without
    a card; ``device="cpu"`` runs the plain version."""

    def __init__(
        self,
        batch: int | None = None,
        n_devices: int | None = None,
        device: str = "cuda",
        slots_per_device: int = 1,
        kernel: str | None = None,
        sub: int = _DEFAULT_SUB,
        threads: int = _DEFAULT_THREADS,
    ):
        self.mesh = make_mesh(n_devices, device, slots_per_device)
        on_card = self.mesh.device_type == "cuda"
        if kernel is None:
            # The card runs the kernel; a CPU mesh runs the plain version
            # (the kernel's wrapper would run it there too).
            kernel = "cuda" if on_card else "plain"
        if kernel not in KERNELS:
            raise ValueError(f"unknown sharded kernel {kernel!r}")
        if batch is None:
            batch = _DEFAULT_BATCH if on_card else _CPU_BATCH
        if batch <= 0 or batch & (batch - 1):
            raise ValueError(f"batch must be a power of two, got {batch}")
        if kernel == "cuda":
            # The kernel step's own guards, at construction: its nonces
            # tile as (sub, threads) blocks and its first-hit min runs in
            # int32.
            block = _check_tile(batch, sub, threads)
            if batch % block:
                raise ValueError(
                    f"per-device batch {batch} must be a multiple of {block} for the cuda kernel"
                )
            if batch >= 1 << 31:
                raise ValueError(f"per-device batch {batch} must be < 2**31")
        self.device = self.mesh.devices[0]
        self.n_devices = self.mesh.size
        self.batch = batch
        self.kernel = kernel
        self.sub = sub
        self.threads = threads
        self.step_span = self.n_devices * batch
        if self.step_span >= 1 << 32:
            raise ValueError(
                f"step span {self.step_span} (= {self.n_devices} devices x "
                f"batch {batch}) must stay below uint32 nonce space"
            )
        # No opening ramp: the span is fixed, which a pod's lockstep needs.
        self.ramp_floor = None
        self._step: StepFn | None = None

    def _make_step(self, span: int) -> StepFn:
        assert span == self.step_span, "sharded step span is fixed"
        if self._step is None:
            self._step = jit_sharded_step(self.mesh, self.batch, self.kernel, self.sub, self.threads)
        return self._step

    def _global_offset(self, offset: int) -> int:
        """The min over every process of the mesh (a lockstep collective:
        each process calls it at the same drain of the same step)."""
        if self.mesh.group is None:
            return offset
        import torch.distributed as dist

        cell = torch.tensor([offset], dtype=torch.int64)
        dist.all_reduce(cell, op=dist.ReduceOp.MIN, group=self.mesh.group)
        return int(cell[0])
