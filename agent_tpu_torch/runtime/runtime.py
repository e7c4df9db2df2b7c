"""The device runtime: owns the device mesh, the build-once cache of
forward functions, and the device-resident model weights.

Counterpart of ``agent_tpu.runtime.runtime.TpuRuntime``. With no device
given it takes ``cuda:0`` and raises when CUDA is absent: the port never
quietly runs on the CPU. Callers that want the CPU (the tests) pass
``device="cpu"``.

A mesh (``mesh_shape``, or ``MESH_SHAPE="dp=2,tp=2"`` for
:func:`get_runtime`) covers the given ``devices``, or, without them, the
first cards of that many; a device listed more than once holds several
shards (one card running a mesh of four: ``devices=["cuda:0"] * 4``). One
process owns the whole mesh. Its axes are ``dp`` (batch rows), ``tp``
(Megatron-split weights), ``sp`` (ring attention), ``pp`` (the GPipe
encoder pipeline) and ``ep`` (MoE experts); any other axis is refused.
:meth:`get_params` with ``specs`` places a model's weights over the mesh
(``parallel.shardings``), :meth:`put_batch` splits a batch over ``dp``, and
:meth:`attention_fn` launches the kernel once per (dp, tp) shard.

The device knobs of ``DeviceConfig`` apply when no device is given:
``TPU_DISABLED=1`` is the operator's request for a CPU runtime;
``CHIP_SLICE="start:count"`` takes cards ``start .. start+count-1``; and
``PALLAS_ATTN=0`` is refused on a CUDA runtime, which has no attention path
without the hand-written kernels (on the CPU the plain versions always run,
so it changes nothing there).

Several processes (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``): the runtime joins the group (``runtime.distributed``)
before it picks devices, as the reference's does, and exposes ``dist``.
Each process's own devices are the ones above (its ``CHIP_SLICE``, or the
first card); the mesh lists process 0's, then process 1's, and so on, with
``dp`` over all of them unless ``MESH_SHAPE`` says otherwise (on a
one-card host every process lists ``cuda:0``). ``devices`` are this
process's. The dp reductions of ``parallel.collectives`` combine across
processes; a model op on such a mesh raises :meth:`require_local`'s
``RuntimeError``, as the reference's fetch of a result with pieces on
other processes' devices does.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from agent_tpu_torch.runtime.mesh import PORTED_AXES, build_mesh, check_sizes
from agent_tpu_torch.utils.logging import log


class BuildOnceCache:
    """Thread-safe build-once map: key -> built value. The build runs outside
    the lock, and concurrent first callers of one key wait for one build."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cache: Dict[Hashable, Any] = {}
        self._building: Dict[Hashable, threading.Event] = {}
        self._generation = 0  # bumped by clear(); a racing build is not kept
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        while True:
            with self._lock:
                if key in self._cache:
                    self.hits += 1
                    return self._cache[key]
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    self.misses += 1
                    gen = self._generation
                    break
            ev.wait()
        try:
            value = build()
            with self._lock:
                if gen == self._generation:
                    self._cache[key] = value
            return value
        finally:
            with self._lock:
                self._building.pop(key).set()

    def evict(self, key: Hashable) -> None:
        with self._lock:
            self._cache.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._generation += 1

    def keys(self) -> List[Hashable]:
        with self._lock:
            return list(self._cache)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._cache), "hits": self.hits, "misses": self.misses}


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchRuntime: no CUDA device is available; pass "
                "device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"TorchRuntime: {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"TorchRuntime: unsupported device {dev}")
    return dev


def _mesh_devices(device, devices: Optional[Sequence],
                  mesh_shape: Optional[Dict[str, int]]) -> List[torch.device]:
    """The devices the mesh covers: ``devices`` as given, else ``device``
    alone, else, for a ``mesh_shape`` of N devices, the first N cards."""
    if devices is not None:
        if device is not None:
            raise ValueError("TorchRuntime: pass device or devices, not both")
        devs = [_resolve_device(d) for d in devices]
        if not devs or len({d.type for d in devs}) != 1:
            raise ValueError(f"TorchRuntime: devices {devices} must be one or more "
                             "devices of one type")
        return devs
    if device is not None or not mesh_shape:
        return [_resolve_device(device)]
    check_sizes(mesh_shape)
    n = int(np.prod(list(mesh_shape.values()), dtype=np.int64))
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        raise RuntimeError(
            f"TorchRuntime: mesh {mesh_shape} needs {n} CUDA devices and {visible} "
            f"are visible; to run several shards on one card, list it so: "
            f"devices=['cuda:0'] * {n}")
    return [torch.device("cuda", i) for i in range(n)]


def parse_chip_slice(spec: str) -> Tuple[int, int]:
    """``"start:count"`` -> ``(start, count)``, validated as the reference
    does: two ints, start >= 0, count >= 1."""
    parts = spec.split(":")
    if len(parts) != 2:
        raise ValueError(f"CHIP_SLICE must be 'start:count', got {spec!r}")
    try:
        start, count = int(parts[0]), int(parts[1])
    except ValueError as exc:
        raise ValueError(f"CHIP_SLICE must be 'start:count' ints, got {spec!r}") from exc
    if start < 0 or count < 1:
        raise ValueError(f"CHIP_SLICE needs start >= 0 and count >= 1, got {spec!r}")
    return start, count


def _configured_devices(config) -> Optional[List[str]]:
    """The devices the config's knobs pick when the caller names none:
    the CPU for ``TPU_DISABLED`` (``count`` CPU devices for a ``CHIP_SLICE``
    of ``count``, as the reference's host devices), cards ``start ..
    start+count-1`` for a ``CHIP_SLICE`` (the reference's
    ``apply_chip_slice``), else None (the first card, or the first cards of
    the mesh)."""
    if config.tpu_disabled:
        log("TPU_DISABLED set: the runtime runs on the CPU")
        return ["cpu"] * (parse_chip_slice(config.chip_slice)[1] if config.chip_slice else 1)
    if not config.chip_slice:
        return None
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return apply_chip_slice([f"cuda:{i}" for i in range(visible)], config.chip_slice)


def apply_chip_slice(devices: Sequence, spec: str) -> list:
    """The ``[start, start+count)`` slice of ``devices``; a slice past the
    visible devices raises rather than running on fewer."""
    start, count = parse_chip_slice(spec)
    if start + count > len(devices):
        want = f"card {start}" if count == 1 else f"cards [{start}, {start + count})"
        raise ValueError(f"CHIP_SLICE {spec!r} wants {want} but only "
                         f"{len(devices)} are visible")
    return list(devices)[start:start + count]


def _process_mesh(local: List[torch.device], mesh_shape: Optional[Dict[str, int]], info):
    """The mesh over every process's devices, in process order, each
    position owned by the process that listed it (``dp`` over all of them
    without ``mesh_shape``)."""
    from agent_tpu_torch.runtime.distributed import all_gather_object

    every = all_gather_object([str(d) for d in local])
    devices = [torch.device(d) for names in every for d in names]
    owners = [p for p, names in enumerate(every) for _ in names]
    return build_mesh(devices, mesh_shape, owners=owners, process_index=info.process_index)


class TorchRuntime:
    """A device mesh, a forward-function cache and a weights store. Weights
    placed without specs, and batches put whole, live on the mesh's first
    device."""

    def __init__(self, device=None, devices: Optional[Sequence] = None,
                 mesh_shape: Optional[Dict[str, int]] = None, config=None) -> None:
        from agent_tpu_torch.config import DeviceConfig
        from agent_tpu_torch.runtime.distributed import maybe_initialize

        self.config = config or DeviceConfig()
        # Join first: the devices below depend on this process's place.
        self.dist = maybe_initialize(self.config.coordinator_address,
                                     self.config.num_processes, self.config.process_id)
        mesh_shape = mesh_shape or self.config.mesh_shape or None
        several = self.dist.process_count > 1
        if device is None and devices is None:
            configured = _configured_devices(self.config)
            if configured is not None and len(configured) == 1 and (several or not mesh_shape):
                device = configured[0]
            else:
                devices = configured
        self.devices = _mesh_devices(device, devices, None if several else mesh_shape)
        if several:
            self.mesh = _process_mesh(self.devices, mesh_shape, self.dist)
        else:
            self.mesh = build_mesh(self.devices, mesh_shape)
        unknown = [n for n in self.mesh.axis_names if n not in PORTED_AXES]
        if unknown:
            raise ValueError(f"TorchRuntime: no path reads mesh axes {unknown}; the "
                             f"axes are {list(PORTED_AXES)}")
        self.device = self.devices[0]
        self.platform = self.device.type  # "cuda" | "cpu"
        if self.config.compute_dtype != "bfloat16":
            raise ValueError(
                f"TorchRuntime: COMPUTE_DTYPE={self.config.compute_dtype!r} sets no dtype in "
                "the port: each model computes in its config's dtype (a payload's "
                "model_config {\"dtype\": ...}); unset it")
        if self.platform == "cuda" and not self.config.pallas_attn:
            raise RuntimeError(
                "TorchRuntime: PALLAS_ATTN=0 asks for attention without the kernels, and "
                "the port has no such path on the card; unset it, or ask for the CPU "
                "(TPU_DISABLED=1)")
        self.cache = BuildOnceCache()
        self._params = BuildOnceCache()  # model id -> module on the device

    # ---- topology ----

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def require_local(self, op: str) -> None:
        """Raise ``RuntimeError`` naming ``op`` when another process holds
        a position of the mesh: the op's result would have pieces there,
        and the port, as the reference, cannot fetch them (it neither waits
        in a collective nor runs the whole batch in this process)."""
        if self.mesh.spans_processes:
            raise RuntimeError(
                f"{op}: the result spans devices of other processes (mesh {self.mesh.shape} "
                f"over {self.dist.process_count} processes); fetching it is not possible "
                f"here, as in the reference")

    def axis_size(self, name: str) -> int:
        return self.mesh.shape.get(name, 1)

    @property
    def sharded(self) -> bool:
        """Whether a model runs sharded here: the mesh has ``dp``, ``tp``,
        ``pp`` or ``ep`` above 1 (``sp`` alone shards attention only)."""
        return any(self.axis_size(a) > 1 for a in ("dp", "tp", "pp", "ep"))

    def attention_fn(self):
        """The attention function: ring attention over ``sp`` when the mesh
        has ``sp`` > 1 (the fold kernel in every hop, in each (dp, tp)
        group), else the flash kernel path (the CUDA kernel on the card, its
        plain version on the CPU), launched once per (dp, tp) shard. Each
        sends the shapes it does not take to dense attention. A sharded
        model asks the function for each shard's own (``.shard(i, j)``)."""
        if self.axis_size("sp") > 1:
            from agent_tpu_torch.parallel.ring import make_ring_attention

            return make_ring_attention(self.mesh)
        from agent_tpu_torch.kernels.flash_attention import make_flash_attention

        return make_flash_attention(self.mesh)

    def t5_attention_kernel(self):
        """The T5 encoder's attention kernel: the CUDA T5 kernel on the card,
        its plain version on a CPU runtime (the same entry either way; it
        returns None for shapes it does not take). On an ``sp`` mesh too the
        T5 encoder runs it unsharded, not the ring, as the reference does."""
        from agent_tpu_torch.kernels.flash_attention import make_flash_attention_t5

        return make_flash_attention_t5(self.mesh)

    def train_attention_fn(self):
        """The differentiable attention function for the training path: the
        flash kernels in both directions (their plain versions on the CPU,
        dense attention for shapes the kernels do not take), per (dp, tp)
        shard. Ring attention is forward-only, as the reference's, so an
        ``sp`` mesh trains on dense attention."""
        if self.axis_size("sp") > 1:
            from agent_tpu_torch.models.layers import dot_product_attention

            return dot_product_attention
        from agent_tpu_torch.kernels.flash_attention import make_flash_attention_trainable

        return make_flash_attention_trainable(self.mesh)

    # ---- weights store ----

    def get_params(self, model_id: str, build: Callable[[], Any], specs=None,
                   place: Optional[Callable[..., Any]] = None) -> Any:
        """Weights built once per model id and placement.

        Without ``specs``: ``build()`` returns a module (or a tensor tree
        the caller owns), and a module is moved to the first device.

        With ``specs`` (a flat spec dict of ``parallel.shardings``) the
        weights are placed over the mesh: ``build()`` returns the host flat
        arrays, and ``place(flat, specs, mesh)`` builds the sharded model.
        When the mesh has ``tp`` or ``ep`` above 1 the specs are sanitized
        against it and the weights land split, under a key of their own
        (``"tp"``); otherwise every leaf replicates (``"rep"``), as the
        reference's placement does."""
        from agent_tpu_torch.parallel.shardings import placement_specs, splits_weights

        self.require_local(f"model {model_id}")
        use_specs = specs is not None and splits_weights(self.mesh.shape)

        def put() -> Any:
            value = build()
            if specs is None:
                return value.to(self.device) if hasattr(value, "to") else value
            return place(value, placement_specs(self.mesh.shape, value, specs), self.mesh)

        return self._params.get_or_build((model_id, "tp" if use_specs else "rep"), put)

    def evict_params(self, model_id: str) -> None:
        """Drop ``model_id`` under either placement."""
        self._params.evict((model_id, "tp"))
        self._params.evict((model_id, "rep"))

    def clear_params(self) -> None:
        """Drop every resident model; the next ``get_params`` rebuilds."""
        self._params.clear()

    # ---- forward functions ----

    def compiled(self, key: Tuple[Hashable, ...], build: Callable[[], Callable]) -> Callable:
        """The callable for ``key``, built at most once (PyTorch runs eagerly:
        what is cached is the forward bound to its model and shape)."""
        return self.cache.get_or_build(key, build)

    def dp_devices(self) -> List[torch.device]:
        """The first device of each dp replica, in dp order."""
        return [self.mesh.device_at(dp=i) for i in range(self.axis_size("dp"))]

    def put_batch(self, arr):
        """Host batch (numpy) -> device. A tensor already on this runtime's
        device passes through (the agent's pipeline pre-feeds staged
        chunks), and uint16 ids widen to int32 (torch's uint16 support is
        thin). On CUDA the copy goes through pinned memory with
        ``non_blocking=True``; PyTorch's pinned-memory allocator keeps the
        staging buffer alive until the stream has read it."""
        if isinstance(arr, torch.Tensor) and arr.device == self.device:
            return arr
        if arr.dtype == np.uint16:
            arr = arr.astype(np.int32)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def peak_flops(self) -> Optional[float]:
        """Peak dense-bf16 FLOP/s of one device (the MFU denominator):
        ``PEAK_TFLOPS`` first, else the card's spec-sheet figure; None when
        unknown."""
        from agent_tpu_torch.obs.health import resolve_peak_flops

        return resolve_peak_flops(self)

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "platform": self.platform,
            "n_devices": self.n_devices,
            "device": str(self.device),
            "mesh": self.mesh.shape,
            "mesh_devices": [str(d) for d in self.devices],
            "process_index": self.dist.process_index,
            "process_count": self.dist.process_count,
            # The fleet's default quant mode (TPU_QUANT); each task resolves
            # its own (ops._model_common.resolve_quant).
            "quant_default": self.config.quant or "none",
            "executable_cache": self.cache.stats(),
            "models_resident": sorted({k[0] if isinstance(k, tuple) else k
                                       for k in self._params.keys()}),
        }
        if self.config.chip_slice:
            out["chip_slice"] = self.config.chip_slice
        if self.device.type == "cuda":
            out["device_kind"] = torch.cuda.get_device_name(self.device)
        # Memory across every card the runtime owns (a card an sp ring lists
        # twice counts once); absent on the CPU.
        from agent_tpu_torch.obs.profile import hbm_totals

        try:
            hbm = hbm_totals(self.devices)
        except Exception:  # noqa: BLE001 — telemetry must never raise
            hbm = None
        if hbm:
            for kind, key in (("used", "hbm_bytes_in_use"), ("limit", "hbm_bytes_limit"),
                              ("peak", "hbm_peak_bytes")):
                if kind in hbm:
                    out[key] = hbm[kind]
            out["hbm_per_device"] = hbm["per_device"]
        return out


class HostCopy:
    """A device result on its way to the host. On CUDA the constructor
    queues a ``non_blocking`` copy into pinned memory on the current stream
    and records an event after it; ``numpy()`` waits on that event alone.
    So a thread that finalizes shard i waits for shard i's copy, not for the
    work the device thread has queued behind it (``Tensor.cpu()`` would
    synchronize the whole stream). On the CPU it holds the tensor."""

    def __init__(self, t: torch.Tensor) -> None:
        self._event = None
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
            t = host
        self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


# Process-wide singleton, built lazily.
_runtime: Optional[TorchRuntime] = None
_runtime_lock = threading.Lock()


def get_runtime(config=None) -> TorchRuntime:
    """The process-wide runtime, on ``MESH_SHAPE``'s mesh when it is set,
    with ``config`` (else ``DeviceConfig.from_env()``)."""
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            from agent_tpu_torch.config import DeviceConfig

            config = config or DeviceConfig.from_env()
            _runtime = TorchRuntime(config=config)
        return _runtime


def reset_runtime() -> None:
    """Tests only: drop the singleton so the next get_runtime rebuilds."""
    global _runtime
    with _runtime_lock:
        _runtime = None
