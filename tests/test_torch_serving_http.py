"""The port's HTTP serving front end against the JAX package's, on the CPU.

Both packages' ``ServingApp`` serve the same JAX-trained model (the port
loads the saved file) behind ``serve_in_thread``; every route answers with
the same status codes and JSON keys. ``GET /metrics`` exposes the same
families, apart from the ``resource_*`` gauges whose probes differ (README,
port section). Then the port's own guard rails of ``/debug/profile`` and
one live ``serve_http`` process.
"""
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.config import ForestConfig as JForestConfig
from repro.data.tabular import two_moons
from repro.launch import serve_http as jhttp
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import ResourceMonitor as JMonitor
from repro.obs import Tracer as JTracer
from repro.serving import AdmissionController as JAdmission
from repro.serving import ModelRegistry as JRegistry
from repro.tabgen import fit_artifacts as j_fit
from repro_torch.launch import serve_http as thttp
from repro_torch.obs import MetricsRegistry, Profiler, ResourceMonitor, Tracer
from repro_torch.serving import AdmissionController, ModelRegistry
from repro_torch.tabgen import TabularGenerator

REPO = pathlib.Path(__file__).resolve().parents[1]


def _http(method, url, body=None, headers=()):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(dict(headers))
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read()
            status, head = resp.status, dict(resp.headers)
    except urllib.error.HTTPError as err:
        raw, status, head = err.read(), err.code, dict(err.headers)
    if head.get("Content-Type") == "application/json":
        return status, head, json.loads(raw)
    return status, head, raw.decode()


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """The same model behind both packages' HTTP planes: ``(jax base URL,
    port base URL, port app, paths)``."""
    tmp = tmp_path_factory.mktemp("planes")
    X, y = two_moons(240, seed=0)
    cfg = JForestConfig(method="flow", n_t=4, duplicate_k=4, n_trees=6,
                        max_depth=3, n_bins=16, reg_lambda=1.0)
    art = j_fit(X, y, cfg, seed=0)
    p1 = art.save(str(tmp / "v1"))
    p2 = art.save(str(tmp / "v2"))
    out, apps, servers = {}, [], []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            metrics, tracer = JMetrics(), JTracer()
            registry = JRegistry(buckets=(64,), metrics=metrics)
            registry.register("moons", art, samplers=("euler", "heun"))
            admission = JAdmission(tenant_rates={"metered": (1.0, 50.0)},
                                   metrics=metrics)
            monitor = JMonitor(metrics, interval_s=60.0, admission=admission,
                               registry=registry)
            mod = jhttp
        else:
            metrics, tracer = MetricsRegistry(), Tracer()
            registry = ModelRegistry(device="cpu", buckets=(64,),
                                     metrics=metrics)
            registry.register("moons", path=p1, samplers=("euler", "heun"))
            admission = AdmissionController(
                tenant_rates={"metered": (1.0, 50.0)}, metrics=metrics)
            monitor = ResourceMonitor(metrics, interval_s=60.0,
                                      admission=admission,
                                      registry=registry)
            mod = thttp
        app = mod.ServingApp(registry, admission, metrics=metrics,
                             tracer=tracer, monitor=monitor,
                             model_paths={"moons": p1})
        monitor.sample()
        httpd, thread = mod.serve_in_thread(app)
        apps.append(app)
        servers.append((httpd, thread))
        out[pkg] = "http://%s:%d" % httpd.server_address[:2]
    yield out["jax"], out["torch"], apps[1], {"v1": p1, "v2": p2,
                                              "tmp": tmp}
    for (httpd, thread), app in zip(servers, apps):
        httpd.shutdown()
        httpd.server_close()
        app.stop()
        thread.join(timeout=10)


def both(planes, method, path, body=None, headers=()):
    jbase, tbase = planes[:2]
    return (_http(method, jbase + path, body, headers),
            _http(method, tbase + path, body, headers))


def _keys(obj, depth=2):
    """The key structure of a JSON value, ``depth`` levels down."""
    if isinstance(obj, dict) and depth:
        return {k: _keys(v, depth - 1) for k, v in obj.items()}
    return type(obj).__name__


@pytest.mark.parametrize("path", ["/healthz", "/v1/models", "/v1/missing",
                                  "/v1/trace/deadbeef"])
def test_get_routes_match_jax(planes, path):
    (js, _, jb), (ts, _, tb) = both(planes, "GET", path)
    assert ts == js
    assert _keys(tb, 3) == _keys(jb, 3)
    if path == "/v1/models":
        for k in ("nbytes", "version", "samplers", "buckets", "n_features",
                  "n_classes", "hot"):
            assert tb["models"]["moons"][k] == jb["models"]["moons"][k], k
    if path == "/healthz":
        assert tb == jb


@pytest.mark.parametrize("body", [
    {"model": "moons", "n": 40, "sampler": "heun", "tenant": "t9",
     "priority": "bulk"},
    {"model": "moons", "n": 7},
    {"model": "nope", "n": 8},
    {"model": "moons", "n": 8, "sampler": "nope"},
    {"model": "moons", "n": 0},
    {"model": "moons", "n": 8, "priority": "express"},
])
def test_generate_matches_jax(planes, body):
    (js, jh, jb), (ts, th, tb) = both(planes, "POST", "/v1/generate", body)
    assert ts == js
    assert set(tb) == set(jb)
    assert ("X-Repro-Request-Id" in th) == ("X-Repro-Request-Id" in jh)
    if ts == 200:
        assert np.asarray(tb["rows"]).shape == np.asarray(jb["rows"]).shape
        assert tb["version"] == jb["version"] and tb["n"] == jb["n"]
        assert np.isfinite(np.asarray(tb["rows"])).all()
        assert sorted(set(tb["labels"])) == sorted(set(jb["labels"]))
    if ts == 404:
        assert tb["models"] == jb["models"]


def test_trace_of_a_request_matches_jax(planes):
    (_, _, jb), (_, _, tb) = both(planes, "POST", "/v1/generate",
                                  {"model": "moons", "n": 24})
    (js, _, jt), (ts, _, tt) = (
        _http("GET", f"{planes[0]}/v1/trace/{jb['request_id']}"),
        _http("GET", f"{planes[1]}/v1/trace/{tb['request_id']}"))
    assert ts == js == 200
    assert set(tt) == set(jt)
    assert set(tt["summary"]) == set(jt["summary"])
    assert set(tt["summary"]["batch"]) == set(jt["summary"]["batch"])
    assert [s["name"] for s in tt["spans"]] == \
        [s["name"] for s in jt["spans"]] == ["serve.queue", "serve.device"]
    assert tt["summary"]["rows"] == 24


@pytest.mark.parametrize("body", [
    {"model": "moons", "rows": [[0.5, None], [None, 0.25]]},
    {"model": "moons", "rows": [[0.5, None], [None, 0.25]],
     "labels": [0, 1]},
    {"model": "moons", "rows": []},
    {"model": "nope", "rows": [[0.5, None]], "labels": [0]},
])
def test_impute_matches_jax(planes, body):
    (js, _, jb), (ts, _, tb) = both(planes, "POST", "/v1/impute", body)
    assert ts == js
    assert set(tb) == set(jb)
    if ts == 200:
        filled = np.asarray(tb["rows"], float)
        assert filled.shape == (2, 2) and np.isfinite(filled).all()
        assert filled[0, 0] == 0.5 and filled[1, 1] == 0.25


def test_statz_and_rate_limit_match_jax(planes):
    gen = {"model": "moons", "n": 40, "tenant": "metered"}
    (js, _, _), (ts, _, _) = both(planes, "POST", "/v1/generate", gen)
    assert ts == js == 200
    (js, jh, jb), (ts, th, tb) = both(planes, "POST", "/v1/generate", gen)
    assert ts == js == 429
    assert set(tb) == set(jb) and tb["retry_after_s"] > 0
    assert float(th["Retry-After"]) > 0
    (js, _, jb), (ts, _, tb) = both(planes, "GET", "/statz")
    assert ts == js == 200
    assert _keys(tb, 2) == _keys(jb, 2)
    assert set(tb["scheduler"]["per_tenant"]) == \
        set(jb["scheduler"]["per_tenant"])


def _families(text):
    return set(re.findall(r"^# TYPE (\S+) ", text, re.M))


def test_metrics_families_match_jax_apart_from_resource_gauges(planes):
    (js, jh, jtext), (ts, th, ttext) = both(planes, "GET", "/metrics")
    assert ts == js == 200 and th["Content-Type"] == jh["Content-Type"]
    jfam, tfam = _families(jtext), _families(ttext)
    assert {f for f in tfam if not f.startswith("resource_")} == \
        {f for f in jfam if not f.startswith("resource_")}
    # the resource gauges the port reads with its own probes (README)
    assert jfam - tfam == {"resource_live_arrays",
                           "resource_jit_cache_entries"}
    assert tfam - jfam == {"resource_kernel_libraries"}
    # no card here: the device gauges are absent, not zero
    assert "resource_device_memory_bytes{" not in ttext


def test_metrics_reconcile_with_statz(planes):
    """/metrics and /statz are views over one registry: the port's plane
    reports the same totals through both."""
    base = planes[1]
    _, _, text = _http("GET", f"{base}/metrics")
    _, _, statz = _http("GET", f"{base}/statz")
    sched = statz["scheduler"]

    def total(name):
        return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                   if ln.startswith(name + "{") or ln.startswith(name + " "))

    assert total("serving_requests_total") == sched["requests"] > 0
    assert total("serving_rows_total") == sched["rows"]
    assert total("serving_device_seconds_count") == sched["batches"]
    assert total("serving_device_seconds_sum") == pytest.approx(
        sched["device_s"])
    assert total("serving_queue_wait_seconds_sum") == pytest.approx(
        sched["queue_wait_s"])
    assert total("registry_models") == 1


def test_reload_route_matches_jax(planes):
    paths = planes[3]
    for body, name in (({"path": paths["v2"]}, "moons"),
                       ({"path": paths["v2"]}, "nope"),
                       ({"path": str(paths["tmp"] / "missing")}, "moons"),
                       ({}, "moons")):
        (js, _, jb), (ts, _, tb) = both(
            planes, "POST", f"/v1/models/{name}/reload", body)
        assert ts == js, (name, body)
        assert set(tb) == set(jb)
        if ts == 200:
            assert tb["version"] == jb["version"]
            assert tb["nbytes"] == jb["nbytes"]
    (_, _, jb), (_, _, tb) = both(planes, "GET", "/v1/models")
    assert tb["models"]["moons"]["version"] == \
        jb["models"]["moons"]["version"] == 3
    (js, _, _), (ts, _, _) = both(planes, "POST", "/v1/generate",
                                  {"model": "moons", "n": 5})
    assert ts == js == 200


def test_profile_disabled_and_bad_bodies_match_jax(planes):
    (js, _, jb), (ts, _, tb) = both(planes, "POST", "/debug/profile",
                                    {"duration_ms": 50})
    assert ts == js == 403 and set(tb) == set(jb)
    (js, _, _), (ts, _, _) = both(planes, "POST", "/v1/nowhere", {})
    assert ts == js == 404
    for url in planes[:2]:
        req = urllib.request.Request(f"{url}/v1/generate", method="POST",
                                     data=b"[1, 2]")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400


def test_profile_endpoint_captures_serializes_and_guards(planes):
    app, base = planes[2], planes[1]
    app.profiler = Profiler(str(planes[3]["tmp"] / "profiles"),
                            max_seconds=5.0)
    try:
        done = {}

        def long_capture():
            done.update(_http("POST", f"{base}/debug/profile",
                              {"duration_ms": 600})[2])

        t = threading.Thread(target=long_capture)
        t.start()
        deadline = time.monotonic() + 10.0
        while not app.profiler.active:
            assert time.monotonic() < deadline, "capture never started"
            time.sleep(0.01)
        status, _, body = _http("POST", f"{base}/debug/profile",
                                {"duration_ms": 100})
        assert status == 409 and "already running" in body["error"]
        t.join(timeout=60)
        assert done["duration_s"] == pytest.approx(0.6)
        assert os.path.exists(done["trace"])
        status, _, _ = _http("POST", f"{base}/debug/profile",
                             {"duration_ms": -5})
        assert status == 400
        app.admin_token = "s3cret"
        status, _, _ = _http("POST", f"{base}/debug/profile",
                             {"duration_ms": 50})
        assert status == 401
        status, _, body = _http("POST", f"{base}/debug/profile",
                                {"duration_ms": 50},
                                headers={"X-Repro-Admin-Token": "s3cret"})
        assert status == 200 and os.path.exists(body["trace"])
    finally:
        app.admin_token = None
        app.profiler = None


def test_serve_http_live_process(tmp_path):
    """``python -m repro_torch.launch.serve_http`` on the CPU: prints its
    address, serves, and exits cleanly on SIGINT."""
    X, y = two_moons(200, seed=0)
    from repro_torch.config import ForestConfig
    cfg = ForestConfig(n_t=3, duplicate_k=3, n_trees=4, max_depth=2,
                       n_bins=8)
    path = TabularGenerator(cfg).fit(X, y, device="cpu").save(
        str(tmp_path / "m"))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_http",
         "--model", f"m={path}", "--port", "0", "--buckets", "64",
         "--device", "cpu", "--resource-interval-s", "30",
         "--trace-jsonl", str(tmp_path / "spans.jsonl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(REPO))
    base, lines = None, []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on "):
                base = line.split()[-1].strip()
                break
        assert base, "server never came up:\n" + "".join(lines)
        status, _, body = _http("GET", f"{base}/healthz")
        assert status == 200 and body["models"] == ["m"]
        status, _, body = _http("POST", f"{base}/v1/generate",
                                {"model": "m", "n": 32})
        assert status == 200 and len(body["rows"]) == 32
        status, _, text = _http("GET", f"{base}/metrics")
        assert status == 200 and "resource_rss_bytes" in text
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert proc.returncode == 0
    rest = proc.stdout.read()
    assert "bye" in rest, rest
    assert (tmp_path / "spans.jsonl").read_text().count("serve.queue") == 1
