"""OOM retry state machine — spill, retry, then recursively split.

Reference: DeviceMemoryEventHandler.scala:42-69 (RMM alloc-failure →
synchronous spill → retry) plus the split-and-retry escalation the
reference grew for work that genuinely does not fit (the
RmmRapidsRetryIterator family: spill first, then halve the input and retry
each half). Both live here as a wrapper at the launch site:

    launch ──OOM──▶ spill everything spillable ──▶ retry      (× maxRetries)
        └─still OOM──▶ split batch in half ──▶ recurse on each half
              └─at the min-rows floor──▶ re-raise (task retry / query fail)

Splitting is sound only for operators whose output over ``concat(a, b)``
equals ``concat(output(a), output(b))`` — project, filter, the partial
update aggregate, and the probe side of a hash join. Those operators opt in
by routing their per-batch launches through ``run_with_retry``; everything
else uses the non-splitting ``run_once`` (spill-retry only).

Copied from ``spark_rapids_tpu/resilience/retry.py``, with what torch and
CUDA change:

* **Classification.** Eager torch raises an allocation failure at the
  allocation, on the host, inside the op that asked: the caching
  allocator's ``torch.cuda.OutOfMemoryError``, or the CUDA runtime's "out
  of memory" where a library allocates outside it. Those, ``MemoryError``
  and the injected fault are OOMs, found anywhere in the cause chain.
* **Sticky device errors.** A kernel's own fault (an illegal address, a
  launch failure, a device-side assert) is asynchronous: it surfaces at a
  later sync, in whichever op happened to wait, and it leaves the CUDA
  context unusable, so any retry fails again and could hide the first
  fault. ``is_sticky_device_error`` names them; they are never retried,
  never split, never task-retried, and fail the query.
* **Honest attribution of an asynchronous fault.** A sticky error that
  surfaces in op X was raised by some kernel launched since the device's
  last completed sync, by X or by an op before it. So it is not pinned on
  X: the breaker records it as an unattributed device fault, naming X only
  as where it surfaced (``CircuitBreaker.record_device_fault``), and opens
  no op. Under ``CUDA_LAUNCH_BLOCKING=1`` every launch syncs, the fault
  surfaces in the op that launched it, and it counts against that op like
  any synchronous device error.
* **The allocator's cache.** After a real OOM the spill frees blocks into
  torch's caching allocator, which keeps them reserved; ``empty_cache``
  hands them back before the retry (see ``_release_cache``).
* **Splitting.** ``split_batch`` halves a batch at half its capacity, as
  the JAX one does, with views of the halves' rows and the padding of each
  half masked inert.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable, Iterator, Optional

from . import faults

log = logging.getLogger(__name__)

# the CUDA runtime's message for an allocation failure outside torch's
# caching allocator (cuBLAS workspaces, a kernel's own cudaMalloc)
_OOM_TOKENS = ("out of memory", "Out of memory")
# errors after which the CUDA context is unusable (cudaErrorIllegalAddress,
# cudaErrorLaunchFailure, cudaErrorAssert, cudaErrorIllegalInstruction,
# cudaErrorMisalignedAddress, cudaErrorHardwareStackError, ECC)
_STICKY_TOKENS = (
    "illegal memory access",
    "illegal address",
    "unspecified launch failure",
    "device-side assert",
    "illegal instruction",
    "misaligned address",
    "hardware stack error",
    "uncorrectable ECC",
    "context is destroyed",
)


# ── classification ──────────────────────────────────────────────────────────


def walk_causes(err: BaseException) -> Iterator[BaseException]:
    """The exception and its cause/context chain (cycle- and depth-guarded).
    ``__cause__`` (explicit ``raise ... from``) wins over the implicit
    ``__context__`` at each link, matching traceback rendering."""
    seen: set[int] = set()
    e: Optional[BaseException] = err
    while e is not None and id(e) not in seen and len(seen) < 16:
        seen.add(id(e))
        yield e
        e = e.__cause__ if e.__cause__ is not None else e.__context__


def _torch_oom_type():
    import torch

    return torch.cuda.OutOfMemoryError


def is_sticky_device_error(err: BaseException) -> bool:
    """A CUDA error after which the context is unusable, anywhere in the
    cause chain. Never recoverable and never retried."""
    for e in walk_causes(err):
        s = str(e)
        if any(tok in s for tok in _STICKY_TOKENS):
            return True
    return False


def is_oom_error(err: BaseException) -> bool:
    """Device allocation failure anywhere in the cause chain — the
    recoverable class (spill / split / retry). A sticky error never is."""
    if is_sticky_device_error(err):
        return False
    oom_type = _torch_oom_type()
    for e in walk_causes(err):
        if isinstance(e, faults.InjectedFault) and e.kind == "oom":
            return True
        if isinstance(e, (MemoryError, oom_type)):
            return True
        s = str(e)
        if any(tok in s for tok in _OOM_TOKENS):
            return True
    return False


def is_real_oom(err: BaseException) -> bool:
    """An OOM the device raised (not an injected one)."""
    oom_type = _torch_oom_type()
    return any(
        isinstance(e, oom_type) or (
            not isinstance(e, faults.InjectedFault)
            and any(tok in str(e) for tok in _OOM_TOKENS)
        )
        for e in walk_causes(err)
    )


def is_device_error(err: BaseException) -> bool:
    """Non-OOM device/kernel failure anywhere in the cause chain — the
    class the CPU-fallback circuit breaker counts: the injected kernel
    fault, a sticky CUDA error, or any other error the CUDA runtime or a
    hand kernel's launch reported."""
    import torch

    accel = getattr(torch, "AcceleratorError", ())
    for e in walk_causes(err):
        if isinstance(e, faults.InjectedFault) and e.kind == "kernel":
            return True
        if accel and isinstance(e, accel):
            return True
        if "CUDA error" in str(e) or "CUDA kernel errors" in str(e):
            return True
    return is_sticky_device_error(err)


# ── retry counters (the bench / profiling diag block) ──────────────────────
# Counters live in the process-wide typed registry (obs/metrics.py) under
# the ``resilience.`` prefix; ``report()`` is a registry view.

from ..obs.metrics import GLOBAL as _REGISTRY  # noqa: E402

_METRICS_LOCK = threading.Lock()
_LAST_OOM: Optional[float] = None  # time.monotonic of the last observed OOM


def record(name: str, n: int = 1) -> None:
    _REGISTRY.counter("resilience." + name).add(n)


def report() -> dict:
    """Cumulative process-wide resilience counters — a view over the
    registry's ``resilience.`` slice."""
    return _REGISTRY.view("resilience.")


def reset() -> None:
    global _LAST_OOM
    _REGISTRY.reset("resilience.")
    with _METRICS_LOCK:
        _LAST_OOM = None


def _note_oom(catalog) -> None:
    """Mark the query whose catalog this is as having met a device OOM:
    its joins close their probe window and output cut from then on
    (exec/gpu_join.py). That flag is per query, never process-wide, so one
    query's OOM does not change another's batch boundaries. The process-
    wide timestamp behind :func:`oom_pressure` changes no batch boundary:
    it only narrows the pipeline's prefetch window and the scheduler's
    permit limit for a while."""
    global _LAST_OOM
    if catalog is not None:
        catalog.oom_handled = True
    with _METRICS_LOCK:
        _LAST_OOM = time.monotonic()


def oom_pressure(window_s: float = 30.0) -> bool:
    """Whether an OOM was handled recently — consumers that buffer ahead
    (the pipeline prefetcher) clamp their windows, and the admission pool
    halves its permits, while this holds."""
    last = _LAST_OOM
    return last is not None and (time.monotonic() - last) < window_s


# ── policy ─────────────────────────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 2
    split_enabled: bool = True
    min_split_rows: int = 1024

    @classmethod
    def from_conf(cls, conf) -> "RetryPolicy":
        from .. import config as cfg

        return cls(
            max_retries=cfg.RETRY_OOM_MAX_RETRIES.get(conf),
            split_enabled=cfg.RETRY_OOM_SPLIT_ENABLED.get(conf),
            min_split_rows=cfg.RETRY_OOM_MIN_SPLIT_ROWS.get(conf),
        )


DEFAULT_POLICY = RetryPolicy()


# ── batch splitting ────────────────────────────────────────────────────────


def split_batch(batch):
    """(lo, hi) halves of a DeviceBatch at half its capacity. Live rows
    occupy the prefix [0, num_rows), so lo takes rows [0, cap/2) and hi rows
    [cap/2, cap); each half's validity is re-masked past its own count so
    padding rows stay inert, and the counts stay on the device. The halves'
    planes are views of the batch's: a split runs because memory ran out,
    so it allocates only the two validity masks."""
    import torch

    from ..columnar.device import DeviceBatch, dc_replace, map_planes

    cap = batch.capacity
    half = cap // 2
    assert half >= 1, "cannot split a capacity-1 batch"

    def part(lo: int, hi: int):
        n = torch.clamp(batch.num_rows - lo, 0, hi - lo).to(torch.int32)
        live = torch.arange(hi - lo, dtype=torch.int32, device=batch.device) < n
        cols = []
        for c in batch.columns:
            c = map_planes(c, lambda t: t[lo:hi])
            cols.append(dc_replace(c, validity=c.validity & live))
        return DeviceBatch(batch.schema, cols, n)

    return part(0, half), part(half, cap)


# ── the state machine ──────────────────────────────────────────────────────


def _spill_all(catalog) -> int:
    try:
        return catalog.synchronous_spill(catalog.device_bytes)
    except Exception:  # spilling is best-effort recovery, never the error
        return 0


def _release_cache() -> None:
    """Return the caching allocator's free blocks to the driver, after a
    real OOM and its spill, before the retry. The spill just moved buffers
    off the card, but torch keeps their blocks reserved in its cache, split
    into the sizes the old tensors had; the retry's allocations differ in
    size, and under a per-process cap a reserved-but-free block counts
    against the cap. Done here, once per real OOM, outside the ``except``
    block: until that block ends, the exception's traceback holds the
    failed attempt's frames and every tensor they allocated. Emptying the
    cache on every launch instead would cost each allocation a driver
    call."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _recover(catalog, real: bool) -> None:
    _spill_all(catalog)
    if real:
        _release_cache()


def _batch_size(batch) -> int:
    sb = getattr(batch, "size_bytes", None)
    if callable(sb):
        try:
            return int(sb())
        except Exception:
            return 0
    return 0


def _handle_non_oom(err, op, breaker) -> None:
    """Feed the circuit breaker on non-OOM device failures (the caller
    re-raises). A blown compile deadline force-opens in one step; a sticky
    error is recorded unattributed unless launches are synchronous (module
    docstring)."""
    from .watchdog import CompileDeadlineError

    if breaker is None or not op:
        return
    for e in walk_causes(err):
        if isinstance(e, CompileDeadlineError):
            breaker.force_open(op, e)
            return
    if not is_device_error(err):
        return
    if is_sticky_device_error(err) and os.environ.get("CUDA_LAUNCH_BLOCKING") != "1":
        breaker.record_device_fault(op, err)
        err.device_fault_recorded = True  # the task loop records it once
    else:
        breaker.record_failure(op, err)


def _label_launch(op: Optional[str]) -> None:
    """Stamp the op signature as the current token's stall-phase detail, so
    a stall detected in a launch names the op it wedged in."""
    if not op:
        return
    from .watchdog import current as _wd_current

    tok = _wd_current()
    if tok is not None:
        tok.phase_detail = op


def launch(fn: Callable, *args):
    """One attempt of device work under a recovery scope. The outermost
    scope is the fault-injection point of ``deviceOomEveryN`` (a nested
    wrapper does not count its launch twice)."""
    outer = not faults.in_recoverable_scope()
    with faults.recoverable():
        if outer:
            faults.on_kernel_launch()
            # wedged-device simulation (kernelStallEveryN): the launch
            # SLEEPS instead of failing — the watchdog's stall cancel is
            # what recovers it
            faults.on_kernel_stall()
        return fn(*args)


def run_once(catalog, fn: Callable, batch, policy: Optional[RetryPolicy] = None,
             op: Optional[str] = None, breaker=None):
    """Spill-and-retry WITHOUT splitting (operators whose work is not
    distributive over row ranges: final/merge aggregates, sorts)."""
    policy = policy or DEFAULT_POLICY
    _label_launch(op)
    attempt = 0
    while True:
        try:
            if faults._ACTIVE is not None:
                faults.on_batch_launch(_batch_size(batch))
            return launch(fn, batch)
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_oom_error(e):
                _handle_non_oom(e, op, breaker)
                raise
            _note_oom(catalog)
            if catalog is None or attempt >= policy.max_retries:
                raise
            real = is_real_oom(e)
        attempt += 1
        record("oom_retries")
        log.warning(
            "device OOM at %s (attempt %d/%d): spilling %d bytes and retrying",
            op or "kernel", attempt, policy.max_retries, catalog.device_bytes,
        )
        _recover(catalog, real)


def run_with_retry(catalog, fn: Callable, batch,
                   policy: Optional[RetryPolicy] = None,
                   op: Optional[str] = None, breaker=None) -> Iterator:
    """Yield ``fn`` outputs covering ``batch`` in row order, escalating
    OOMs: spill-retry up to ``policy.max_retries``, then recursively halve
    down to the ``min_split_rows`` floor. The caller must accept MULTIPLE
    output batches per input batch — that is the splittable-operator
    contract. The halves run one after the other, lazily: the first half's
    output is yielded before the second half launches."""
    policy = policy or DEFAULT_POLICY
    _label_launch(op)
    attempt = 0
    while True:
        try:
            if faults._ACTIVE is not None:
                faults.on_batch_launch(_batch_size(batch))
            out = launch(fn, batch)
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_oom_error(e):
                _handle_non_oom(e, op, breaker)
                raise
            _note_oom(catalog)
            split = catalog is None or attempt >= policy.max_retries
            cap = getattr(batch, "capacity", 0)
            if split and (not policy.split_enabled or cap <= max(2, policy.min_split_rows)):
                raise
            real = is_real_oom(e)
        else:
            yield out
            return
        if not split:
            attempt += 1
            record("oom_retries")
            log.warning(
                "device OOM at %s (attempt %d/%d): spilling %d bytes and retrying",
                op or "kernel", attempt, policy.max_retries, catalog.device_bytes,
            )
            _recover(catalog, real)
            continue
        record("splits")
        log.warning(
            "device OOM at %s persists after spills: splitting batch "
            "(capacity %d -> 2x%d) and retrying each half",
            op or "kernel", cap, cap // 2,
        )
        if real:
            _release_cache()
        lo, hi = split_batch(batch)
        yield from run_with_retry(catalog, fn, lo, policy, op, breaker)
        del lo
        yield from run_with_retry(catalog, fn, hi, policy, op, breaker)
        return
