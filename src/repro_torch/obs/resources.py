"""ResourceMonitor: where the bytes go, as gauges.

The port's twin of the JAX package's ``repro.obs.resources``.
:class:`ResourceMonitor` samples

* host RSS (current + peak, from ``/proc/self/status``, with a
  ``resource.getrusage`` fallback), as the JAX package reads it;
* device memory per CUDA device, from the caching allocator:
  ``torch.cuda.memory_allocated`` (``bytes_in_use``),
  ``max_memory_allocated`` (``peak_bytes_in_use``) and
  ``memory_reserved`` (``bytes_reserved``) under
  ``resource_device_memory_bytes{device, kind}``, and the allocated bytes
  again under ``resource_device_buffer_bytes{device}``;
* the kernel libraries that :mod:`repro_torch.kernels.build` has loaded,
  under ``resource_kernel_libraries`` (the JAX package counts jit cache
  entries there: the port compiles nothing at run time, so a library
  loaded is its one compile-time event);
* live queue depths per priority from an
  :class:`~repro_torch.serving.admission.AdmissionController`;
* hot-model bytes and counts from a
  :class:`~repro_torch.serving.registry.ModelRegistry`,

into ``resource_*`` gauges on a :class:`~repro_torch.obs.MetricsRegistry`
(default: the process-wide :func:`repro_torch.obs.default_registry`). On a
host without CUDA the device gauges are absent, not zero.

``sample()`` is one synchronous pass; ``start()``/``stop()`` run it on a
daemon thread every ``interval_s`` seconds and are idempotent. Sampling
never raises out of the background thread.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["ResourceMonitor"]


def _host_rss() -> Tuple[int, int]:
    """(current_rss_bytes, peak_rss_bytes), best effort.

    ``/proc/self/status`` gives both on Linux; the ``getrusage`` fallback
    only knows the peak, which is then reported for both.
    """
    try:
        cur = peak = 0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    cur = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
        if cur:
            return cur, peak or cur
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        return peak, peak
    except Exception:
        return 0, 0


def _device_memory() -> Dict[str, Dict[str, int]]:
    """``{"cuda:i": {kind: bytes}}`` from the caching allocator of every
    CUDA device; empty without CUDA."""
    import torch
    if not torch.cuda.is_available():
        return {}
    mem = {}
    for i in range(torch.cuda.device_count()):
        mem[f"cuda:{i}"] = {
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            "bytes_reserved": int(torch.cuda.memory_reserved(i)),
        }
    return mem


def _kernel_libraries() -> int:
    """Kernel libraries loaded by :func:`repro_torch.kernels.build.load`."""
    from repro_torch.kernels.build import load
    return int(load.cache_info().currsize)


class ResourceMonitor:
    """Background sampler publishing ``resource_*`` gauges.

    ``admission`` and ``registry`` are optional serving-plane hooks: when
    given, queue depths and hot-model placement ride the same sample.
    Pass the serving process's shared ``metrics`` registry (as
    ``serve_http`` does) so ``/metrics`` carries the gauges.
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None, *,
                 interval_s: float = 5.0,
                 admission=None, registry=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        if metrics is None:
            from repro_torch.obs import default_registry
            metrics = default_registry()
        self.metrics = metrics
        self.interval_s = float(interval_s)
        self.admission = admission
        self.registry = registry
        m = metrics
        self._g_rss = m.gauge(
            "resource_rss_bytes", "Host resident set size (current)")
        self._g_rss_peak = m.gauge(
            "resource_rss_peak_bytes", "Host resident set size (peak)")
        self._g_dev_buffers = m.gauge(
            "resource_device_buffer_bytes",
            "Bytes of live tensors per CUDA device "
            "(torch.cuda.memory_allocated)", ("device",))
        self._g_dev_mem = m.gauge(
            "resource_device_memory_bytes",
            "Caching allocator stats per CUDA device (bytes_in_use, "
            "peak_bytes_in_use, bytes_reserved); absent without CUDA",
            ("device", "kind"))
        self._g_kernel_libs = m.gauge(
            "resource_kernel_libraries",
            "CUDA kernel libraries loaded into the process")
        self._g_queue_depth = m.gauge(
            "resource_queue_depth",
            "Admission queue depth per priority class (sampled)",
            ("priority",))
        self._g_hot_bytes = m.gauge(
            "resource_hot_model_bytes",
            "Device-placed model bytes (sampled from the model registry)")
        self._g_hot_models = m.gauge(
            "resource_hot_models", "Device-placed model count (sampled)")
        self._m_samples = m.counter(
            "resource_samples", "Resource sampling passes completed")
        self._lifecycle = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one sampling pass ---------------------------------------------------

    def _sample_device(self, out: dict) -> None:
        mem = _device_memory()
        with self.metrics.lock:
            self._g_dev_buffers.reset()
            for dev, kinds in mem.items():
                self._g_dev_buffers.set(kinds["bytes_in_use"], device=dev)
                for kind, nbytes in kinds.items():
                    self._g_dev_mem.set(nbytes, device=dev, kind=kind)
        if mem:
            out["device_memory"] = mem
            out["device_buffer_bytes"] = {
                dev: kinds["bytes_in_use"] for dev, kinds in mem.items()}
        libs = _kernel_libraries()
        self._g_kernel_libs.set(libs)
        out["kernel_libraries"] = libs

    def sample(self) -> dict:
        """One synchronous pass: update every gauge, return the readings
        (a JSON-serializable dict)."""
        out: dict = {}
        cur, peak = _host_rss()
        self._g_rss.set(cur)
        self._g_rss_peak.set(peak)
        out["rss_bytes"], out["rss_peak_bytes"] = cur, peak
        try:
            self._sample_device(out)
        except Exception:
            pass  # a device refusing introspection keeps the host gauges
        if self.admission is not None:
            depths = self.admission.queued()
            for prio, depth in depths.items():
                self._g_queue_depth.set(depth, priority=prio)
            out["queue_depth"] = dict(depths)
        if self.registry is not None:
            hot_bytes = self.registry.hot_bytes()
            hot_models = len(self.registry.hot_names())
            self._g_hot_bytes.set(hot_bytes)
            self._g_hot_models.set(hot_models)
            out["hot_model_bytes"] = int(hot_bytes)
            out["hot_models"] = hot_models
        self._m_samples.inc()
        return out

    # -- background lifecycle ------------------------------------------------

    def _loop(self) -> None:
        while True:
            try:
                self.sample()
            except Exception:
                pass  # a failed pass must never kill the sampler thread
            if self._stop_evt.wait(self.interval_s):
                return

    def start(self) -> bool:
        """Start the sampler thread (samples immediately, then every
        ``interval_s``). Idempotent: returns False when already running."""
        with self._lifecycle:
            if self._thread is not None and self._thread.is_alive():
                return False
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="resource-monitor", daemon=True)
            self._thread.start()
            return True

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop the sampler thread. Idempotent: returns False when not
        running. A stopped monitor can be ``start()``ed again."""
        with self._lifecycle:
            t, self._thread = self._thread, None
            if t is None or not t.is_alive():
                return False
            self._stop_evt.set()
        t.join(timeout)
        return True

    @property
    def running(self) -> bool:
        with self._lifecycle:
            return self._thread is not None and self._thread.is_alive()
