"""Runtime flag registry (counterpart of ``paddle_tpu/flags.py``).

Every flag of the reference, with its name, type, default and
``FLAGS_<name>`` environment seeding, so that ``get_flags``/``set_flags``
accept every reference name.  The port reads the serving flags
(``serving/``), ``weight_quant_*`` (``quantize/``),
``retrace_warn_threshold`` (``jit/compile_cache.py``), ``check_shapes``
(``ops/op.py``), ``exact_dropout_mask`` (``nn/functional/common.py``),
``fault_injection``/``fault_injection_seed`` (``utils/failpoint.py``) and
``check_numerics`` (``amp/debugging.py``, which also keeps
``check_nan_inf`` and ``low_precision_op_list`` as its state, as the
reference's does).  The reference's compat no-ops are accepted and read
by nothing, there as here.  A flag the reference reads and the port does
not yet (``_NO_READER``, with the ROADMAP item that ports its reader)
keeps its default: a non-default value, from ``set_flags`` or the
environment, raises NotImplementedError.  ``on_flag_set`` hooks a
subsystem to a flag, as the reference's does.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Union

__all__ = [
    "define_flag",
    "get_flags",
    "set_flags",
    "flag_info",
    "all_flags",
    "on_flag_set",
    "pg_timeout",
]

_TRUE_STRINGS = {"1", "true", "yes", "on"}
_FALSE_STRINGS = {"0", "false", "no", "off"}


@dataclass
class FlagInfo:
    """Metadata for one registered flag (mirrors ``ExportedFlagInfoMap``)."""

    name: str
    default: Any
    doc: str
    type: type
    value: Any
    is_writable: bool = True


# flags the reference reads whose reader the port does not have yet, with
# where that reader is to come from
_NO_READER: Dict[str, str] = {
    "jit_max_programs": "the reference's to_static program cache, which "
                        "the port does not have",
    "compile_cache_min_compile_secs": "nvcc, which builds the port's "
                                      "kernel cache, has no compile-time "
                                      "threshold",
    **dict.fromkeys((
        "telemetry", "telemetry_http_port", "flight_recorder_size",
        "flight_recorder_dir", "device_profiler", "device_profiler_sample_ms",
        "kernel_attribution", "numerics_interval", "numerics_dump_dir",
        "numerics_spike_window", "numerics_spike_factor", "trace_sample_rate",
        "trace_buffer_traces", "trace_dump_dir", "fleet_health_secs",
        "fleet_collect_timeout_secs", "fleet_straggler_factor"),
        "ROADMAP A5"),
    **dict.fromkeys((
        "serving_slo_ttft_ms", "serving_slo_tpot_ms",
        "serving_router_health_secs", "serving_router_max_missed",
        "serving_router_probe_timeout_secs", "serving_router_heal_probes",
        "serving_migration_timeout_secs", "serving_migration_wire_codec",
        "serving_request_log_size", "serving_shed_queue_delay_ms",
        "serving_shed_kv_watermark", "serving_shed_interactive_factor",
        "serving_tenant_budget_tokens_per_s", "serving_autoscaler_secs",
        "serving_autoscaler_slo_target", "serving_autoscaler_high_load",
        "serving_autoscaler_low_load", "serving_autoscaler_hysteresis",
        "serving_autoscaler_cooldown_secs",
        "serving_autoscaler_max_replicas"), "ROADMAP A5 and A6"),
    **dict.fromkeys((
        "pg_timeout", "comm_abort_on_timeout", "comm_latency_histograms",
        "comm_slow_warn_secs", "comm_quant_block", "comm_quant_min_bytes",
        "comm_bucket_bytes", "quantized_collectives", "sharding_report_dir"),
        "ROADMAP A7"),
}


def _refuse_unread(name: str, value: Any, default: Any) -> None:
    item = _NO_READER.get(name)
    if item is not None and value != default:
        raise NotImplementedError(
            f"FLAGS_{name}={value!r}: nothing in the port reads this flag "
            f"yet ({item}); only its default {default!r} is accepted")


class _FlagRegistry:
    def __init__(self) -> None:
        self._flags: Dict[str, FlagInfo] = {}
        self._hooks: Dict[str, Any] = {}
        self._lock = threading.RLock()

    def define(self, name: str, default: Any, doc: str = "",
               flag_type: Optional[type] = None, writable: bool = True) -> None:
        with self._lock:
            if name in self._flags:
                raise ValueError(f"flag '{name}' is already defined")
            ftype = flag_type or type(default)
            value = default
            env = os.environ.get(f"FLAGS_{name}")
            if env is not None:
                value = _parse(env, ftype)
                _refuse_unread(name, value, default)
            self._flags[name] = FlagInfo(name=name, default=default, doc=doc,
                                         type=ftype, value=value,
                                         is_writable=writable)

    def get(self, names: Union[str, Iterable[str]]):
        single = isinstance(names, str)
        if single:
            names = [names]
        out = {}
        with self._lock:
            for n in names:
                info = self._flags.get(_canon(n))
                if info is None:
                    raise KeyError(f"flag '{n}' is not defined")
                out[info.name] = info.value
        if single:
            return next(iter(out.values()))
        return out

    def set(self, flags: Dict[str, Any]) -> None:
        fire = []
        with self._lock:
            for n, v in flags.items():
                info = self._flags.get(_canon(n))
                if info is None:
                    raise KeyError(f"flag '{n}' is not defined")
                if not info.is_writable:
                    raise ValueError(f"flag '{info.name}' is not writable")
                value = _coerce(v, info.type)
                _refuse_unread(info.name, value, info.default)
                info.value = value
                hook = self._hooks.get(info.name)
                if hook is not None:
                    fire.append((hook, info.value))
        # hooks run outside the lock so they may themselves read/set flags
        for hook, value in fire:
            hook(value)

    def on_set(self, name: str, callback) -> None:
        with self._lock:
            self._hooks[_canon(name)] = callback

    def info(self, name: str) -> FlagInfo:
        with self._lock:
            return self._flags[_canon(name)]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._flags)


def _canon(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def _parse(text: str, ftype: type):
    if ftype is bool:
        low = text.strip().lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        raise ValueError(f"cannot parse boolean flag value {text!r}")
    return ftype(text)


def _coerce(value: Any, ftype: type):
    if isinstance(value, ftype):
        return value
    if isinstance(value, str):
        return _parse(value, ftype)
    return ftype(value)


_REGISTRY = _FlagRegistry()


def define_flag(name: str, default: Any, doc: str = "",
                flag_type: Optional[type] = None, writable: bool = True) -> None:
    _REGISTRY.define(name, default, doc, flag_type, writable)


def get_flags(names: Union[str, Iterable[str]]):
    """Return flag values — dict for an iterable, scalar for a single name."""
    return _REGISTRY.get(names)


def set_flags(flags: Dict[str, Any]) -> None:
    _REGISTRY.set(flags)


def flag_info(name: str) -> Dict[str, Any]:
    """One flag's record as a dict (name, default, doc, type, value,
    is_writable)."""
    return dict(vars(_REGISTRY.info(name)))


def all_flags() -> List[str]:
    return _REGISTRY.names()


def on_flag_set(name: str, callback) -> None:
    """Register ``callback(new_value)`` to run whenever ``name`` is set
    via :func:`set_flags` (used by subsystems that must react to a flag,
    e.g. utils/failpoint arming from ``FLAGS_fault_injection``)."""
    _REGISTRY.on_set(name, callback)


def non_default_flags() -> Dict[str, Any]:
    """{name: value} for every flag whose current value differs from its
    default — the configuration snapshot flight-recorder dump headers
    carry so a post-mortem shows the flags that produced the events
    (docs/observability.md).  Values are kept JSON-friendly."""
    out: Dict[str, Any] = {}
    with _REGISTRY._lock:
        for name, info in _REGISTRY._flags.items():
            if info.value != info.default:
                v = info.value
                if not isinstance(v, (bool, int, float, str, type(None))):
                    v = repr(v)
                out[name] = v
    return out


def pg_timeout() -> float:
    """The one host-side blocking-point timeout knob (store barriers,
    comm watchdog, RPC deadlines). Shared accessor so every consumer
    agrees on the lookup and the fallback."""
    try:
        return float(get_flags("pg_timeout"))
    except Exception:  # noqa: BLE001 — registry unavailable mid-import
        return float(os.environ.get("FLAGS_pg_timeout", "1800"))


# ---------------------------------------------------------------------------
# Core framework flags (subset of the reference's 125, TPU-relevant ones).
# ---------------------------------------------------------------------------
define_flag("check_nan_inf", False,
            "Check every op output for NaN/Inf (reference: "
            "paddle/phi/core/flags.cc:80 FLAGS_check_nan_inf).")
# pt-lint: disable=registry-consistency — parity surface: level is accepted but only 0 (error) is implemented
define_flag("check_nan_inf_level", 0,
            "0: error on nan/inf; 1: warn; 2: collect stats only.")
# pt-lint: disable=registry-consistency — parity no-op: XLA owns threading; accepted, never read
define_flag("paddle_num_threads", 1,
            "Host-side intra-op threads (XLA manages device parallelism).")
# pt-lint: disable=registry-consistency — parity surface: eager dispatch always jits; flag accepted for scripts that set it
define_flag("eager_op_jit", True,
            "Dispatch eager ops through cached jax.jit callables.")
define_flag("check_shapes", True,
            "Run infer_meta shape/dtype checks before eager dispatch "
            "(ops/op.py). Disable for peak dispatch throughput once a "
            "model is shape-stable.")
define_flag("low_precision_op_list", False,
            "Collect per-op AMP dtype statistics.")
# pt-lint: disable=registry-consistency — documented compat no-op
define_flag("use_stride_kernel", False,
            "Compat no-op: XLA has no strided view kernels.")
# pt-lint: disable=registry-consistency — documented compat no-op (informational)
define_flag("allocator_strategy", "auto_growth",
            "Compat: device memory is owned by XLA; value is informational.")
# pt-lint: disable=registry-consistency — documented compat no-op
define_flag("tracer_mkldnn_ops_on", "", "Compat no-op.")
# pt-lint: disable=registry-consistency — documented compat no-op
define_flag("max_inplace_grad_add", 0, "Compat no-op.")
# pt-lint: disable=registry-consistency — parity no-op: XLA scatter-add is already deterministic on TPU
define_flag("embedding_deterministic", 0,
            "Force deterministic embedding grad accumulation.")
# pt-lint: disable=registry-consistency — parity alias accepted from CUDA configs; no cudnn here
define_flag("cudnn_deterministic", False, "Compat alias for determinism.")
# pt-lint: disable=registry-consistency — parity surface: XLA dispatch is async-only; accepted, never read
define_flag("benchmark", False, "Synchronise after every op when timing.")
define_flag("jit_max_programs", 32,
            "Per-function cap on to_static's guard-keyed compiled-program "
            "cache; beyond it the function falls back to eager with a "
            "warning (reference jit/sot compile-cache limit role). "
            "0 disables the cap.")
define_flag("pg_timeout", 1800.0,
            "Host-side collective/store-barrier timeout in seconds "
            "(reference genv.pg_timeout; enforced by the comm watchdog, "
            "distributed/communication/watchdog.py).")
define_flag("comm_abort_on_timeout", False,
            "Abort the process when the comm watchdog flags a wedged "
            "host-side comm task, so the elastic layer can restart the "
            "job (reference CommTaskManager async error handling).")
define_flag("fault_injection", "",
            "Failpoint spec arming deterministic fault injection in the "
            "host runtime, e.g. 'store.client.req=error,p=0.1;"
            "rpc.server.handle=hang_once,arg=0.5'. Empty string disables "
            "(zero overhead). See docs/robustness.md and "
            "paddle_tpu/utils/failpoint.py.")
define_flag("fault_injection_seed", 0,
            "Base seed for deterministic fault injection when "
            "core.random_state is not loaded (dataloader worker "
            "subprocesses read the FLAGS_fault_injection_seed env var "
            "directly so parent and child draw the same faults).")
define_flag("telemetry", False,
            "Arm structured tracing + step telemetry "
            "(paddle_tpu/telemetry/trace.py). Disarmed, every instrumented "
            "hot path guards itself with a single attribute check — zero "
            "overhead. See docs/observability.md.")
define_flag("flight_recorder_size", 2048,
            "Capacity of the distributed flight recorder's event ring "
            "(paddle_tpu/telemetry/flight_recorder.py). 0 disables "
            "recording entirely; the ring is armed by default because its "
            "per-event cost is a dict append on already-blocking paths "
            "(store wire ops, rpc, retries), never the dispatch hot path.")
define_flag("flight_recorder_dir", "",
            "Directory flight-recorder dumps are written to on watchdog "
            "timeout / WorkerError / explicit dump(). Empty = the system "
            "temp directory.")
define_flag("compile_cache_dir", "auto",
            "Persistent cross-process XLA compilation cache directory "
            "(paddle_tpu/jit/compile_cache.py wires it into JAX's "
            "jax_compilation_cache_dir). 'auto' (the default) resolves to "
            "$XDG_CACHE_HOME/paddle_tpu/xla_cache; '' / 'off' / 'none' "
            "disables persistence. See docs/performance.md.")
define_flag("compile_cache_max_bytes", 2 * 1024 ** 3,
            "Size cap for the persistent compilation cache directory; the "
            "LRU eviction sweep (compile_cache.sweep, run at arming time) "
            "deletes least-recently-used entries beyond it. 0 disables "
            "the sweep.")
define_flag("compile_cache_min_compile_secs", 1.0,
            "Only compilations that took at least this many seconds are "
            "persisted (JAX's jax_persistent_cache_min_compile_time_secs)."
            " The default keeps per-op eager compiles out of the cache; "
            "set 0 to persist everything (tests do).")
define_flag("retrace_warn_threshold", 8,
            "Warn once a captured step (a train step, a serving step "
            "signature) has been captured this many times — the recapture "
            "tripwire (jit/compile_cache.py note_trace). 0 disables the "
            "warning.")
define_flag("device_profiler", False,
            "Arm the device-side memory profiler "
            "(paddle_tpu/telemetry/device_profiler.py): live-HBM "
            "attribution into params/grads/optimizer-state/data via "
            "jax.live_arrays(), per-phase snapshots in training loops, a "
            "sampled per-step peak timeline, and an automatic ranked "
            "memory report + flight-recorder dump on RESOURCE_EXHAUSTED. "
            "Disarmed, instrumented paths cost one attribute check. "
            "See docs/observability.md (Device-side).")
define_flag("device_profiler_sample_ms", 25,
            "Sampling interval of the device profiler's peak-tracking "
            "thread (feeds device.memory.update_peaks so per-phase peaks "
            "are measurements, not query-time artifacts). 0 disables the "
            "sampler thread; snapshots still work.")
define_flag("kernel_attribution", False,
            "Thread jax.named_scope through every OpDef.jitted trace and "
            "the TrainStepCapture phases (forward/backward/update) so "
            "XPlane kernel spans fold back onto framework op names in "
            "profiler summaries (profiler/device_trace.py op_stats). "
            "Trace-time only — compiled executions never run the scope. "
            "Arm BEFORE building models: scopes apply at trace time.")
define_flag("comm_latency_histograms", True,
            "Record a latency histogram per eager collective "
            "(comm.all_reduce_seconds, ...) in "
            "distributed/communication/api.py, surfaced in the profiler "
            "DistributedView table and Prometheus. Rides paths that "
            "already block on the network; disable for one-attribute-"
            "check zero overhead.")
define_flag("comm_slow_warn_secs", -1.0,
            "Slow-collective tripwire: a collective slower than this "
            "leaves a comm.slow flight event + comm.slow_total count, so "
            "a degrading link is visible before the watchdog declares it "
            "hung. -1 (default) = half of FLAGS_pg_timeout; 0 disables.")
define_flag("sharding_report_dir", "",
            "When set, every partition-rule application "
            "(distributed/partitioning apply_rules) dumps its sharding "
            "report — per-param resolved rule, PartitionSpec, per-device "
            "bytes, unmatched/replicated list — as JSON into this "
            "directory, next to the report rendered in the Distributed "
            "Summary. Empty (default) disables. See docs/sharding.md.")
define_flag("serving_block_size", 16,
            "Tokens per KV-cache page in the serving engine's paged "
            "allocator (serving/kv_cache.py).")
define_flag("serving_num_blocks", 512,
            "Pages in the preallocated KV-cache pool, per layer (K and V "
            "each). Page 0 is the padding sink, so serving_num_blocks - 1 "
            "pages are usable.")
define_flag("serving_max_batch", 8,
            "Decode batch of the continuous-batching scheduler: every "
            "decode step runs at exactly this batch, padded with inert "
            "rows.")
define_flag("serving_prefill_chunk", 128,
            "Prefill token budget per scheduler step; shorter chunks are "
            "padded to it.")
define_flag("serving_kv_quant", "off",
            "Paged KV-cache pool precision (serving/kv_cache.py): 'off' "
            "keeps pools in the model dtype; 'int8' stores K/V pages as "
            "symmetric int8 codes with one f32 scale per (token, kv-head) "
            "vector in a (pages, page, Hkv, 1) scale pool beside each page "
            "pool, quantized on write by paged_kv_update_quant and "
            "dequantized by the decode kernel after each row's load. Read "
            "at pool construction only.")
define_flag("weight_quant_group", 128,
            "In-dim rows per scale group for weight-only quantization "
            "(quantize/): each (group x out-column) block of a Linear "
            "weight carries one f32 scale beside its int8/int4 codes.")
define_flag("weight_quant_kernel", "auto",
            "Weight-only quant_matmul dispatch (ops/cuda/quant_matmul.py), "
            "decided when quantize_for_inference builds each layer: 'auto' "
            "uses the CUDA kernel for weights on a CUDA device and the "
            "plain dequantize-then-matmul path on the CPU; 'on'/'off' force "
            "one path ('on' on the CPU routes through the kernel wrapper, "
            "which computes its plain version for CPU tensors; 'off' on the "
            "card is the caller's explicit choice of the plain path).")
define_flag("serving_use_rpa_kernel", "auto",
            "Ragged paged attention decode kernel dispatch: 'auto' uses the "
            "CUDA kernel when the engine runs on a CUDA device and the plain "
            "gather path on the CPU; 'on'/'off' force one path ('on' on the "
            "CPU routes decode through the kernel wrapper, which computes "
            "its plain version for CPU tensors).")
define_flag("serving_prefix_cache", "on",
            "Cross-request prefix cache over the paged KV pool "
            "(content-hashed full blocks, refcounts, copy-on-write, LRU). "
            "'off' gives every request private block tables. Read at "
            "engine/pool construction.")
define_flag("telemetry_http_port", 0,
            "Arm the telemetry HTTP endpoint "
            "(paddle_tpu/telemetry/exporter.py) on this port: GET "
            "/metrics serves the Prometheus text exposition, /healthz a "
            "JSON health/load snapshot (KV-pool utilization, queue "
            "depth, retraces, last-step age — a replica router's "
            "admission signals), /statusz the live + recent per-request "
            "timelines. 0 (default) disables; the server runs on a "
            "background daemon thread and shuts down via atexit / "
            "ServingEngine.close(). See docs/observability.md.")
define_flag("serving_slo_ttft_ms", 0.0,
            "Time-to-first-token SLO target in milliseconds, scored per "
            "request at finish against its effective arrival time "
            "(serving/request_log.py): a request whose TTFT exceeds it "
            "misses SLO and its tokens count toward "
            "serving.tokens_total but NOT serving.goodput_tokens_total. "
            "0 (default) disables the TTFT check.")
define_flag("serving_slo_tpot_ms", 0.0,
            "Time-per-output-token SLO target in milliseconds (mean "
            "inter-token gap over the request's whole life, so a "
            "preemption stall counts against it). Scored together with "
            "serving_slo_ttft_ms into serving.slo_attained_total and "
            "the goodput split. 0 (default) disables the TPOT check.")
define_flag("serving_router_health_secs", 0.5,
            "Replica-router health probe cadence in seconds "
            "(serving/router.py): each tick every replica's /healthz "
            "admission signals (kv_utilization, queue_depth, rank/"
            "replica identity) are re-read and drain decisions made. "
            "A replica reporting unhealthy (HTTP 503) is drained "
            "immediately; an UNREACHABLE one after "
            "serving_router_max_missed consecutive missed probes.")
define_flag("serving_router_max_missed", 3,
            "Consecutive failed health probes (connection refused / "
            "timeout — missing heartbeats) before the replica router "
            "declares a replica dead and drains it, re-submitting its "
            "in-flight requests to survivors. The 503 path does not "
            "wait for this: an engine that ANSWERS unhealthy is "
            "drained on the first probe.")
define_flag("serving_router_probe_timeout_secs", 1.0,
            "Per-probe timeout for the replica router's HTTP /healthz "
            "reads; a probe slower than this counts as missed.")
define_flag("serving_migration_timeout_secs", 5.0,
            "Deadline for one disaggregated prefill→decode KV-block "
            "migration (serving/migration.py): bundle fetch from the "
            "prefill replica, install on the decode replica, and the "
            "verification ack must all land within it. Individual store "
            "blips retry with backoff inside the window; crossing it "
            "falls back to local prefill-from-prompt on the decode pool "
            "(serving.migration.timeouts_total + a migration_fallback "
            "timeline entry, never a lost or wedged request).")
define_flag("serving_migration_wire_codec", "f32",
            "Payload codec for migrated KV blocks on the wire "
            "(serving/migration.py): 'f32' (default) ships raw "
            "little-endian float32 — exact, so decode-pool greedy "
            "outputs stay byte-equal to single-pool serving; 'int8' "
            "ships the blockwise-quantized form (int8 rows + f32 "
            "scales, comm_quant_block granularity), ~4x less wire at "
            "~0.4%% relative error — an opt-in bandwidth/quality trade. "
            "Both codecs carry the same chain-hash + CRC32 verification.")
define_flag("serving_request_log_size", 256,
            "Completed-request timelines kept in the serving request "
            "log's bounded ring (serving/request_log.py) and served by "
            "the telemetry endpoint's /statusz. Lifecycle events "
            "(submitted, admitted, prefill chunks, first token, "
            "preempted/resumed, finished) cost one timestamped append "
            "each; 0 disables recording entirely.")
define_flag("serving_router_heal_probes", 2,
            "Consecutive healthy probe answers a SUSPECT replica must "
            "deliver before the router returns it to rotation "
            "(serving/router.py heal cooldown). 1 restores the eager "
            "heal-on-first-answer behavior; the default of 2 keeps a "
            "flapping replica (answer, miss, answer, ...) permanently "
            "out of rotation instead of oscillating traffic onto it.")
define_flag("serving_shed_queue_delay_ms", 0.0,
            "Load-shedding watermark on the projected queue delay "
            "(serving/control_plane.py): when the engines' decode-rate "
            "backlog estimate exceeds this, the admission controller "
            "refuses batch-class submits with a retryable "
            "OverloadedError (429-style, retry_after_s attached); "
            "interactive work sheds only past "
            "serving_shed_interactive_factor times it. 0 (default) "
            "disables delay shedding.")
define_flag("serving_shed_kv_watermark", 0.95,
            "KV-pool utilization fraction above which the admission "
            "controller sheds BATCH-class work (interactive admission "
            "relies on priority scheduling and batch-first eviction "
            "instead of this watermark). 0 disables.")
define_flag("serving_shed_interactive_factor", 4.0,
            "Multiplier on serving_shed_queue_delay_ms before "
            "INTERACTIVE work is shed too — graceful degradation: "
            "batch sheds first, interactive only when the backlog is "
            "this many times past the watermark. Clamped to >= 1.")
define_flag("serving_tenant_budget_tokens_per_s", 0.0,
            "Default per-tenant token-bucket refill rate (prompt + "
            "generated tokens per second) for tenants WITHOUT an "
            "explicit AdmissionController.set_budget() entry. 0 "
            "(default) means unconfigured tenants are unlimited — "
            "budgets are opt-in; an explicit set_budget(tenant, 0) "
            "still creates an always-refused zero-budget tenant.")
define_flag("serving_autoscaler_secs", 1.0,
            "SLO-driven autoscaler evaluation cadence in seconds "
            "(serving/control_plane.py ReplicaAutoscaler). Each eval "
            "reads shed/SLO counter deltas plus probed batch-slot "
            "occupancy and votes overload/idle; hysteresis and "
            "cooldown gate the actual scale actions.")
define_flag("serving_autoscaler_slo_target", 0.9,
            "slo_attainment floor for the autoscaler: when the "
            "attained/(attained+missed) rate over an eval window drops "
            "below this, the window votes overload (scale up).")
define_flag("serving_autoscaler_high_load", 0.85,
            "Mean batch-slot occupancy ((active+waiting)/max_batch "
            "over healthy probed replicas) at or above which an eval "
            "votes overload.")
define_flag("serving_autoscaler_low_load", 0.15,
            "Mean batch-slot occupancy at or below which an eval votes "
            "idle (scale-down candidate), provided nothing was shed "
            "and the router backlog is empty.")
define_flag("serving_autoscaler_hysteresis", 3,
            "Consecutive identical autoscaler verdicts (overload or "
            "idle) required before acting on one. One noisy eval "
            "window can never scale the fleet.")
define_flag("serving_autoscaler_cooldown_secs", 5.0,
            "Quiet period after any autoscaler action during which no "
            "further action fires (verdict streaks keep counting, so a "
            "persistent overload acts immediately when the cooldown "
            "ends). Paired with hysteresis this bounds flapping.")
define_flag("serving_autoscaler_max_replicas", 4,
            "Fleet-size ceiling for autoscaler scale-ups (the floor is "
            "the ReplicaAutoscaler min_replicas argument, default 1).")
define_flag("fleet_health_secs", 10.0,
            "Cadence (seconds) at which each rank of a multi-process "
            "mesh publishes its compact health snapshot — step time, "
            "comm seconds, peak HBM, last collective sequence number — "
            "to the TCPStore (telemetry/fleet.py). Rank 0 merges the "
            "snapshots with straggler scoring into the /fleetz route "
            "and the Fleet Summary block. 0 disables fleet health "
            "publication. See docs/observability.md (Fleet view).")
define_flag("fleet_collect_timeout_secs", 5.0,
            "How long the comm-watchdog hang attribution waits for "
            "peers' flight dumps to arrive through the store before "
            "analyzing whatever it has (missing ranks are reported as "
            "unreachable, never crashed on). Keep it well under "
            "FLAGS_pg_timeout so the verdict lands before callers give "
            "up.")
define_flag("fleet_straggler_factor", 1.5,
            "A rank whose mean step time exceeds this multiple of the "
            "fleet median is flagged as a straggler in the /fleetz "
            "summary and the Fleet Summary block "
            "(fleet.straggler_score gauge carries the worst ratio).")
define_flag("quantized_collectives", "off",
            "Int8 block-scaled collectives "
            "(distributed/communication/quantized.py, EQuARX-style): "
            "'off' keeps every collective exact; 'int8' quantizes "
            "all_reduce/reduce_scatter payloads to int8 with per-block "
            "scales (~26% of the fp32 wire bytes); 'auto' quantizes only "
            "float tensors of at least FLAGS_comm_quant_min_bytes (small "
            "control-plane tensors stay exact). Applies to the eager comm "
            "API, the bucketed gradient reduction, and the compiled "
            "train step's all-gather phase. See docs/distributed.md.")
define_flag("comm_quant_block", 512,
            "Elements per quantization block for int8 block-scaled "
            "collectives: each block carries one f32 scale "
            "(max|x|/127), so wire overhead is 4/(block) bytes per "
            "element on top of the 1-byte payload. Smaller blocks track "
            "outliers better; 512 keeps overhead under 1%.")
define_flag("comm_quant_min_bytes", 65536,
            "Under FLAGS_quantized_collectives='auto', tensors smaller "
            "than this stay exact — quantize/dequant overhead dominates "
            "any wire saving below ~64 KiB.")
define_flag("comm_bucket_bytes", 16 * 1024 * 1024,
            "Size bound (bytes of gradient payload) for the bucketed "
            "gradient reduction (distributed/grad_buckets.py): parameters "
            "are fused into buckets up to this size, and each bucket's "
            "reduce-scatter is issued as soon as backward has produced "
            "all of its gradients — instead of one fused post-backward "
            "reduce — so communication overlaps remaining backward "
            "compute (reference reducer.cc group_size_limits role).")
define_flag("check_numerics", "off",
            "Numerics observability arming (telemetry/numerics.py): "
            "'off' (default) costs one attribute check on the dispatch "
            "path; 'stats' hangs on-device stat probes (absmax / rms / "
            "nan+inf counts, fused side-outputs — no host sync in the "
            "hot path) off every op dispatch and every final leaf "
            "gradient, sampled every FLAGS_numerics_interval steps and "
            "jit-safe inside TrainStepCapture (arm BEFORE building the "
            "step: probes ride the trace); 'full' additionally checks "
            "every eager op output on the host immediately and raises "
            "NonFiniteError at the first offending op (the reference "
            "FLAGS_check_nan_inf abort semantics — triage mode, slow). "
            "See docs/observability.md (Numerics).")
define_flag("numerics_interval", 10,
            "Publication cadence (steps) of the armed numerics monitor: "
            "on-device stats are synced to host gauges/histograms, the "
            "loss-spike window updated, and non-finite totals checked "
            "every this-many steps. Stats are COMPUTED every step inside "
            "compiled programs (the program is fixed — 0 retraces); the "
            "interval bounds host-sync cost only. 1 = every step.")
define_flag("numerics_dump_dir", "",
            "Directory numerics non-finite post-mortems (ranked per-op "
            "report JSON naming the first offending op) and calibration "
            "dumps are written to. Empty = the system temp directory "
            "(device-profiler OOM-dump precedent).")
define_flag("numerics_spike_window", 32,
            "Rolling window (steps) of the training-loss spike detector: "
            "a sampled loss exceeding the window median by more than "
            "FLAGS_numerics_spike_factor x the window's median absolute "
            "deviation (with a small relative floor — sign-robust for "
            "negative-loss objectives) records a numerics.loss_spike "
            "flight event + counter. Needs at least 8 samples before it "
            "scores; 0 disables the detector.")
define_flag("numerics_spike_factor", 4.0,
            "Spike threshold multiplier over the rolling-window median "
            "absolute deviation for the numerics loss-spike detector.")
define_flag("trace_sample_rate", 0.0,
            "Arm end-to-end distributed request tracing "
            "(telemetry/tracecontext.py) and head-sample this fraction "
            "of traces by deterministic trace_id hash — every process "
            "takes the same decision without coordination.  Traces "
            "that shed, SLO-miss, error, migrate-with-fallback, or "
            "re-route are ALWAYS kept (tail retention) regardless of "
            "the rate.  0 (default) disarms tracing entirely; armed "
            "hot paths guard with one attribute check. See "
            "docs/observability.md (Distributed request tracing).")
define_flag("trace_buffer_traces", 256,
            "Traces the per-process bounded trace buffer holds before "
            "evicting the oldest (unretained first). Each trace is "
            "additionally capped at tracecontext.MAX_EVENTS_PER_TRACE "
            "events.")
define_flag("trace_dump_dir", "",
            "Directory per-process trace dumps "
            "(pt_trace_<process>_<pid>.json, merged offline by "
            "tools/analyze_trace.py) are written to. Empty = the "
            "system temp directory (flight-recorder precedent).")
define_flag("exact_dropout_mask", False,
            "Force exact Bernoulli(p) dropout masks instead of the "
            "1/256-quantised fast u8 masks (nn/functional/common.py "
            "fast_keep_mask) for parity-sensitive comparisons against "
            "the reference framework.")
