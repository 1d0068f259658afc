"""The port's warm restart (``ContinuousEngine.save_snapshot`` /
``load_snapshot`` over ``repro_torch.checkpoint``), mirroring the
reference's snapshot cases (``tests/test_faults.py``, ``test_overlap.py``,
``test_obs.py``): the round trip and its failure modes (busy engine, empty
directory, geometry mismatch, truncated arrays; nothing half-applied, a
cold engine still serves), the paged-pool guard, a crash-restart across
two processes (this module is its own worker and hard-exits with
``os._exit``), a save that quiesces the overlapped pipeline, the obs
snapshot events; a JAX engine's snapshot restored into the port, whose
follow-up greedy tokens equal the never-restarted JAX engine's (f32); the
launcher's ``--snapshot-dir`` run twice (a cold start, then a restore).

Run as a script (``python tests/test_torch_snapshot.py save|restore
DIR``) it is the crash-restart worker."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import (ContinuousEngine, Fault, FaultPlan,
                                 SamplingParams, corrupt_snapshot)
from repro_torch.serving.faults import PAGE_EXHAUSTION


def _cfg():
    cfg = get_config("qwen3-0.6b").reduced()
    return dataclasses.replace(cfg, kv_k_sparsity=0.3, kv_v_sparsity=0.5,
                               kv_tail=16, compute_dtype="float32",
                               param_dtype="float32")


def _setup():
    cfg = _cfg()
    return cfg, lm.init_params(cfg, seed=0, device="cpu")


def _paged_engine(params, cfg, **kw):
    kw.setdefault("prefill_chunk", 32)
    return ContinuousEngine(params, cfg, slots=2, max_tokens=96, bs=16,
                            paged=True, device="cpu", **kw)


def _waves(cfg, seed=2):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, (48,)).tolist()
    wave = [shared + rng.integers(0, cfg.vocab, (4,)).tolist()
            for _ in range(2)]
    followup = [shared + rng.integers(0, cfg.vocab, (6,)).tolist()
                for _ in range(2)]
    return wave, followup


def _serve(eng, prompts, sp=None):
    sp = sp or SamplingParams(max_new_tokens=6)
    rids = [eng.submit(p, sp) for p in prompts]
    res = eng.run()
    return [list(res[r].token_ids) for r in rids]


def _assert_drained(eng):
    assert eng._inflight is None
    assert not eng.scheduler.active and not eng._blocks
    assert not eng._reserved and not eng._slot_live.any()
    assert int(eng._alloc._ref.sum()) == 0
    assert int(eng.state["refcount"].sum()) == 0


def test_snapshot_roundtrip_and_failure_modes(tmp_path):
    cfg, params = _setup()
    wave, followup = _waves(cfg)
    snap = str(tmp_path / "snap")

    saver = _paged_engine(params, cfg)
    _serve(saver, wave)
    n_pages = len(saver._trie)
    assert n_pages > 0
    assert saver.save_snapshot(snap) == 1
    base_follow = _serve(saver, followup)

    # the busy guard, then the round trip: a fresh engine resumes with the
    # trie populated, the arena tensors where they were, nothing captured
    # again, and the follow-up wave token-identical
    loader = _paged_engine(params, cfg)
    loader.submit(wave[0], SamplingParams(max_new_tokens=6))
    with pytest.raises(ValueError, match="busy"):
        loader.load_snapshot(snap)
    loader.run()                                 # drain; trie gets replaced
    ptrs = [t.data_ptr() for t in
            loader.pool.arena_leaves(loader.state)["l0"].values()]
    captures = dict(loader.trace_counts())
    assert loader.load_snapshot(snap) == n_pages
    assert len(loader._trie) == n_pages
    assert [t.data_ptr() for t in loader.pool.arena_leaves(
        loader.state)["l0"].values()] == ptrs
    assert int(loader.state["refcount"].abs().sum()) == 0
    assert int(loader.state["table"].abs().sum()) == 0
    assert _serve(loader, followup) == base_follow
    assert loader.trace_counts() == captures
    _assert_drained(loader)

    # an empty directory is a readable error
    os.makedirs(str(tmp_path / "void"))
    strict = _paged_engine(params, cfg)
    with pytest.raises(ValueError, match="no snapshot"):
        strict.load_snapshot(str(tmp_path / "void"))

    # geometry mismatch: every differing field named, nothing half-applied
    man = os.path.join(snap, "step_0000000001", "manifest.json")
    with open(man) as f:
        manifest = json.load(f)
    manifest["geometry"]["n_phys"] = 999
    manifest["geometry"]["bs"] = 8
    with open(man, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError) as ei:
        strict.load_snapshot(snap)
    msg = str(ei.value)
    assert "geometry mismatch" in msg
    assert "n_phys" in msg and "999" in msg and "bs" in msg
    assert len(strict._trie) == 0

    # corrupt arrays: readable error, the engine stays cold but serviceable
    with open(man, "w") as f:
        json.dump({**manifest, "geometry": saver.pool.geometry()}, f)
    corrupt_snapshot(snap, mode="truncate")
    cold = _paged_engine(params, cfg)
    before = [t.clone() for t in
              cold.pool.arena_leaves(cold.state)["l0"].values()]
    with pytest.raises(ValueError, match="corrupt"):
        cold.load_snapshot(snap)
    assert len(cold._trie) == 0
    assert cold._alloc.free_blocks() == cold.pool.n_phys
    assert all(torch.equal(a, b) for a, b in zip(before, cold.pool
               .arena_leaves(cold.state)["l0"].values()))
    assert _serve(cold, followup) == base_follow


def test_snapshot_guards_need_paged_pool(tmp_path):
    cfg, params = _setup()
    flat = ContinuousEngine(params, cfg, slots=2, max_tokens=96, bs=16,
                            prefill_chunk=32, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        flat.save_snapshot(str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="paged"):
        flat.load_snapshot(str(tmp_path / "nope"))


def test_load_arena_checks_every_leaf_before_copying():
    cfg, params = _setup()
    eng = _paged_engine(params, cfg)
    leaves = {n: {k: torch.ones_like(t) for k, t in d.items()}
              for n, d in eng.pool.arena_leaves(eng.state).items()}
    last = sorted(leaves)[-1]
    leaves[last]["v_values"] = leaves[last]["v_values"][:, :1]
    with pytest.raises(ValueError, match=f"arena leaf {last}/v_values"):
        eng.pool.load_arena(eng.state, leaves)
    assert all(int(t.abs().sum()) == 0 for d in eng.pool.arena_leaves(
        eng.state).values() for t in d.values())


def test_crash_restart_parity(tmp_path):
    """Process A serves, snapshots, serves the follow-up wave and hard-exits
    (``os._exit``: no teardown).  Process B starts fresh, warm-restarts and
    must restore every page, admit the follow-up wave on trie hits and
    emit A's greedy tokens."""
    snap = str(tmp_path / "snap")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def run_worker(phase):
        out = subprocess.run([sys.executable, __file__, phase, snap],
                             capture_output=True, text=True, timeout=600,
                             env=env, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    a = run_worker("save")
    assert a["n_pages"] > 0 and a["crash"] == "os._exit"
    b = run_worker("restore")
    assert b["restored"] == a["n_pages"]
    assert b["trie_len"] == a["n_pages"]
    assert b["followup_tokens"] == a["followup_tokens"]
    assert b["prefill_skipped"]
    assert b["captures"] == a["captures"]


def test_overlap_snapshot_quiesces_and_roundtrips(tmp_path):
    cfg, params = _setup()
    wave, followup = _waves(cfg)
    sp = SamplingParams(max_new_tokens=6)
    snap = str(tmp_path / "snap")

    serial = _paged_engine(params, cfg, overlap=False)
    base_wave = _serve(serial, wave)
    base_follow = _serve(serial, followup)

    # a mid-traffic save commits the in-flight window first; serving then
    # resumes with identical output
    eng = _paged_engine(params, cfg, overlap=True)
    rids = [eng.submit(p, sp) for p in wave]
    for _ in range(4):
        eng.step()
    assert eng._inflight is not None
    assert eng.save_snapshot(snap) == 1
    assert eng._inflight is None
    out = eng.run()
    assert [list(out[r].token_ids) for r in rids] == base_wave

    # an idle save after the drain, then a fresh overlapped engine
    assert eng.save_snapshot(snap) == 2
    n_pages = len(eng._trie)
    fresh = _paged_engine(params, cfg, overlap=True)
    assert fresh.load_snapshot(snap) == n_pages
    assert _serve(fresh, followup) == base_follow
    _assert_drained(fresh)


def test_obs_traces_snapshots(tmp_path):
    from repro_torch.obs import Observability
    cfg, params = _setup()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (32,)).tolist() for _ in range(3)]
    obs = Observability(trace_path=str(tmp_path / "t.json"))
    eng = _paged_engine(params, cfg, prefill_chunk=16, obs=obs,
                        faults=FaultPlan([Fault(PAGE_EXHAUSTION, 2)]))
    for p in prompts:
        eng.submit(p, SamplingParams(max_new_tokens=4))
    eng.run()
    eng.save_snapshot(str(tmp_path / "snap"))
    eng2 = _paged_engine(params, cfg, prefill_chunk=16, obs=obs)
    assert eng2.load_snapshot(str(tmp_path / "snap")) > 0
    obs.close()
    s = obs.snapshot()
    assert s['repro_fault_injections_total{site="page-exhaustion"}'] == 1.0
    assert s['repro_snapshots_total{kind="save"}'] == 1.0
    assert s['repro_snapshots_total{kind="load"}'] == 1.0
    names = {e["name"] for e in
             json.loads((tmp_path / "t.json").read_text())}
    assert {"fault:page-exhaustion", "snapshot:save",
            "snapshot:load"} <= names


def test_jax_snapshot_restores_into_the_port(tmp_path):
    """A snapshot written by the reference engine (uint32 bitmaps, its
    manifest) restores into the port's engine, whose follow-up wave
    equals the never-restarted reference engine's greedy tokens (f32,
    the same bridged weights)."""
    from repro.serving import ContinuousEngine as JaxEngine
    from repro.serving import SamplingParams as JaxParams
    from torch_parity import configs, sparse_params
    jcfg, tcfg = configs("float32", kv_k_sparsity=0.3, kv_v_sparsity=0.5,
                         kv_tail=16)
    jparams, tparams = sparse_params(jcfg, tcfg)
    wave, followup = _waves(tcfg)
    snap = str(tmp_path / "snap")
    jeng = JaxEngine(jparams, jcfg, slots=2, max_tokens=96, bs=16,
                     prefill_chunk=32, paged=True)
    jsp = JaxParams(max_new_tokens=6)
    for p in wave:
        jeng.submit(p, jsp)
    jeng.run()
    jeng.save_snapshot(snap)
    rids = [jeng.submit(p, jsp) for p in followup]
    res = jeng.run()
    want = [list(res[r].token_ids) for r in rids]

    eng = _paged_engine(tparams, tcfg)
    assert eng.pool.geometry() == jeng.pool.geometry()
    assert eng.load_snapshot(snap) == len(jeng._trie) > 0
    assert dict(eng._trie.items()) == dict(jeng._trie.items())
    assert _serve(eng, followup) == want
    # and the reverse: the port's snapshot restores into the reference
    eng.save_snapshot(snap)
    jfresh = JaxEngine(jparams, jcfg, slots=2, max_tokens=96, bs=16,
                       prefill_chunk=32, paged=True)
    assert jfresh.load_snapshot(snap) == len(eng._trie)


def test_serve_cli_snapshot_dir_cold_then_restored(tmp_path):
    from repro_torch.launch import serve
    args = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--requests", "2", "--slots", "2", "--prompt-len", "40",
            "--steps", "4", "--prefill-chunk", "16", "--paged",
            "--snapshot-dir", str(tmp_path / "snap")]
    outs = []
    for _ in range(2):
        r, w = os.pipe()
        with os.fdopen(w, "w") as fw:
            import contextlib
            with contextlib.redirect_stdout(fw):
                assert serve.main(args) == 0
        outs.append(os.fdopen(r).read())
    assert "[serve] cold start:" in outs[0]
    assert "[serve] snapshot: step 1" in outs[0]
    assert "[serve] warm restart: restored" in outs[1]
    assert "[serve] snapshot: step 2" in outs[1]


# ---------------------------------------------------------------------------
# the crash-restart worker
# ---------------------------------------------------------------------------

def _worker(phase: str, snap: str) -> None:
    cfg, params = _setup()
    wave, followup = _waves(cfg, seed=0)
    eng = _paged_engine(params, cfg)
    if phase == "save":
        _serve(eng, wave)
        n_pages = len(eng._trie)
        eng.save_snapshot(snap)
        print(json.dumps({"n_pages": n_pages,
                          "followup_tokens": _serve(eng, followup),
                          "captures": eng.trace_counts(),
                          "crash": "os._exit"}))
        sys.stdout.flush()
        os._exit(0)                    # die hard: no teardown after save
    elif phase == "restore":
        restored = eng.load_snapshot(snap)
        trie_len = len(eng._trie)
        sp = SamplingParams(max_new_tokens=6)
        rids = [eng.submit(p, sp) for p in followup]
        eng.step()                     # the admission tick
        # a trie hit admits with the restored 48-token prefix prefilled; a
        # cold admission's first chunk is at most 32
        skipped = any(r.prefill_done >= 48
                      for r in eng.scheduler.active.values())
        res = eng.run()
        print(json.dumps({"restored": restored, "trie_len": trie_len,
                          "followup_tokens": [list(res[r].token_ids)
                                              for r in rids],
                          "captures": eng.trace_counts(),
                          "prefill_skipped": skipped}))
    else:
        raise SystemExit(f"unknown phase {phase!r}")


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
