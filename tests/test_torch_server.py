"""The port's asyncio HTTP frontend (``repro_torch.serving.frontend``),
mirroring ``tests/test_server.py``: the JSON parameter whitelist (equal to
the reference's); in-process serving on an ephemeral port (``/healthz``,
``POST /v1/generate`` NDJSON frames whose tokens equal a serial engine's,
``POST /v1/cancel`` mid-stream, 400/404 answers, ``POST /v1/shutdown``
draining the overlapped pipeline); an engine thread that dies takes the
server down with its error; and ``python -m repro_torch.launch.serve
--device cpu --server`` end to end in a subprocess."""
import http.client
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.serving import params_from_json as ref_params_from_json

from repro_torch.serving import (ContinuousEngine, SamplingParams,
                                 ServerFrontend, params_from_json)

from torch_parity import configs, sparse_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_params_from_json_whitelist():
    body = {"temperature": 0.5, "top_k": 3, "max_new_tokens": 4, "seed": 9,
            "deadline_s": 2.5, "unknown_field": 1, "stop_ids": [2, 3]}
    p = params_from_json(body)
    assert (p.temperature, p.top_k, p.max_new_tokens, p.seed,
            p.deadline_s) == (0.5, 3, 4, 9, 2.5)
    d = SamplingParams()
    assert p.stop_ids == d.stop_ids            # excluded from the wire
    assert p.top_p == d.top_p                  # absent -> default
    assert params_from_json({}) == d
    ref = ref_params_from_json(body)
    assert {f: getattr(p, f) for f in ("temperature", "top_k", "top_p",
                                       "seed", "max_new_tokens", "eos_id",
                                       "deadline_s", "ttft_deadline_s",
                                       "stop_ids")} == \
        {f: getattr(ref, f) for f in ("temperature", "top_k", "top_p",
                                      "seed", "max_new_tokens", "eos_id",
                                      "deadline_s", "ttft_deadline_s",
                                      "stop_ids")}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs("float32", kv_k_sparsity=0.3, kv_v_sparsity=0.5,
                         kv_tail=16)
    return tcfg, sparse_params(jcfg, tcfg)[1]


def _engine(params, cfg, **kw):
    return ContinuousEngine(params, cfg, slots=2, max_tokens=96, bs=16,
                            prefill_chunk=32, device="cpu", **kw)


def _conn(port, timeout=120):
    return http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)


def _post(port, path, obj, timeout=60):
    c = _conn(port, timeout)
    c.request("POST", path, json.dumps(obj),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    body = json.loads(r.read())
    c.close()
    return r.status, body


def _stream(resp):
    """Read NDJSON frames off a chunked response until the terminal one."""
    frames = []
    while True:
        line = resp.readline()
        assert line, "stream ended without a terminal frame"
        frames.append(json.loads(line))
        if frames[-1]["finished"]:
            return frames


def _start(front):
    """Run ``front`` on a thread; returns (thread, port)."""
    started, box = threading.Event(), {}

    def ready(port):
        box["port"] = port
        started.set()

    def run():
        try:
            front.run(ready)
        except RuntimeError as e:
            box["raised"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(60), "server never came up"
    return t, box


def test_server_generate_cancel_shutdown(setup):
    cfg, params = setup
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (14,)).tolist()
    serial = _engine(params, cfg)
    rid = serial.submit(prompt, SamplingParams(max_new_tokens=6))
    want = list(serial.run()[rid].token_ids)

    eng = _engine(params, cfg, overlap=True)
    front = ServerFrontend(eng, port=0)
    t, box = _start(front)
    port = box["port"]

    c = _conn(port, 30)
    c.request("GET", "/healthz")
    r = c.getresponse()
    assert r.status == 200 and json.loads(r.read())["ok"]
    c.close()

    c = _conn(port)
    c.request("POST", "/v1/generate",
              json.dumps({"prompt": prompt, "max_new_tokens": 6}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    assert r.status == 200
    assert r.getheader("Content-Type") == "application/x-ndjson"
    frames = _stream(r)
    assert [tok for f in frames for tok in f["tokens"]] == want
    assert frames[-1]["finish_reason"] == "length"
    c.close()

    # cancel a longer request mid-stream: terminal frame says cancelled
    c2 = _conn(port)
    c2.request("POST", "/v1/generate",
               json.dumps({"prompt": prompt, "max_new_tokens": 64}),
               {"Content-Type": "application/json"})
    r2 = c2.getresponse()
    first = json.loads(r2.readline())
    status, body = _post(port, "/v1/cancel",
                         {"request_id": first["request_id"]})
    assert status == 200 and body["cancelled"] is True
    frames = [first] + _stream(r2)
    assert frames[-1]["finish_reason"] == "cancelled"
    got = [tok for f in frames for tok in f["tokens"]]
    assert got == want[:len(got)]              # committed prefix only
    c2.close()

    assert _post(port, "/v1/generate", {"nope": 1})[0] == 400
    assert _post(port, "/v1/cancel", {})[0] == 400
    assert _post(port, "/v1/nothing", {})[0] == 404

    status, body = _post(port, "/v1/shutdown", {})
    assert status == 200 and body["shutting_down"]
    t.join(timeout=120)
    assert not t.is_alive(), "run() did not return after shutdown"
    assert front.loop_thread.error is None and "raised" not in box
    assert eng._inflight is None and not eng.scheduler.active
    assert not eng._slot_live.any() and not eng._pending_release
    assert front.requests_served == 2
    assert eng.fault_counters["cancelled"] == 1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_error_takes_the_server_down(setup):
    """A tick that raises (a failed launch, say) ends the open stream with
    an ``error`` frame, answers later requests 503 or not at all, shuts
    the server down and makes ``run()`` raise the engine's error."""
    cfg, params = setup
    eng = _engine(params, cfg, overlap=True)
    step, ticks = eng.step, [0]

    def failing_step():
        ticks[0] += 1
        if ticks[0] == 3:
            raise RuntimeError("injected launch failure")
        return step()
    eng.step = failing_step
    front = ServerFrontend(eng, port=0)
    t, box = _start(front)
    c = _conn(box["port"])
    c.request("POST", "/v1/generate",
              json.dumps({"prompt": list(range(1, 30)),
                          "max_new_tokens": 20}),
              {"Content-Type": "application/json"})
    frames = _stream(c.getresponse())
    c.close()
    assert frames[-1]["finish_reason"] == "error"
    assert "injected launch failure" in frames[-1]["error"]
    t.join(timeout=60)
    assert not t.is_alive(), "a dead engine left the server serving"
    assert isinstance(front.loop_thread.error, RuntimeError)
    assert isinstance(box["raised"], RuntimeError)
    assert box["raised"].__cause__ is front.loop_thread.error


def test_serve_cli_server_smoke():
    """``launch/serve --device cpu --server`` in a subprocess, with the
    lifecycle and telemetry flags: generate, scrape, shut down, exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--reduced", "--device", "cpu", "--server",
         "--port", "0", "--slots", "2", "--prompt-len", "32", "--steps",
         "8", "--prefill-chunk", "16", "--max-queue", "4",
         "--metrics-port", "0"],
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "OMP_NUM_THREADS": "1"},
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        port = metrics = None
        lines = []
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"(http://127\.0\.0\.1:\d+/metrics)", line)
            if m:
                metrics = m.group(1)
            m = re.search(r"server: http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port and metrics, "URLs never printed:\n" + "".join(lines)

        c = _conn(port)
        c.request("POST", "/v1/generate",
                  json.dumps({"prompt": list(range(1, 17)),
                              "max_new_tokens": 5}),
                  {"Content-Type": "application/json"})
        frames = _stream(c.getresponse())
        assert len([tok for f in frames for tok in f["tokens"]]) == 5
        assert frames[-1]["finish_reason"] == "length"
        c.close()
        import urllib.request
        with urllib.request.urlopen(metrics, timeout=30) as resp:
            text = resp.read().decode()
        assert 'repro_requests_finished_total{reason="length"} 1' in text

        assert _post(port, "/v1/shutdown", {})[1]["shutting_down"]
        assert proc.wait(timeout=120) == 0
        rest = proc.stdout.read()
        assert "server drained" in rest and "fault counters" in rest
        assert "'release': 1, 'set_lane': 1" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
